"""The port's last six workloads (`workloads/sets.py`, `long_fork.py`,
`adya.py`, `causal.py`, `causal_reverse.py`, `monotonic.py`), held
against the JAX package: the twins of `tests/test_workloads.py`'s cases
for them (golden checker maps and end-to-end runs through the
interpreter with in-process clients), each generator's first ops seeded
alike in both packages, and each checker's result on the same seeded
histories (numpy), valid and with a seeded anomaly (a lost set element,
a long fork, a G2, a causal inconsistency, a read missing a preceding
write, a monotonic cycle): equal, exactly (no floats are involved).
"""

import threading

import numpy as np
import pytest

from jepsen_tpu import generator as ref_gen
from jepsen_tpu import independent as ref_independent
from jepsen_tpu.generator import testlib as ref_testlib
from jepsen_tpu.history import History as RefHistory
from jepsen_tpu.history import Op as RefOp
from jepsen_tpu.workloads import adya as ref_adya
from jepsen_tpu.workloads import causal as ref_causal
from jepsen_tpu.workloads import causal_reverse as ref_causal_reverse
from jepsen_tpu.workloads import long_fork as ref_long_fork
from jepsen_tpu.workloads import monotonic as ref_monotonic
from jepsen_tpu.workloads import sets as ref_sets
from jepsen_tpu_torch import client as jclient
from jepsen_tpu_torch import core, independent
from jepsen_tpu_torch import generator as gen
from jepsen_tpu_torch import workloads
from jepsen_tpu_torch.generator import testlib
from jepsen_tpu_torch.history import History, Op
from jepsen_tpu_torch.independent import KV
from jepsen_tpu_torch.workloads import (adya, causal, causal_reverse,
                                        long_fork, monotonic, sets)


def op(typ, process, f, value, time=0, **extra):
    return Op(typ, f=f, process=process, value=value, time=time,
              extra=extra)


def hist(ops):
    return History(ops).index()


def test_package_exports_the_references_workloads():
    import jepsen_tpu.workloads as ref_workloads
    assert workloads.__all__ == ref_workloads.__all__


# -- the twins of tests/test_workloads.py's cases ----------------------------

def rt(k_vs):
    """read txn [[r k v] ...]"""
    return [["r", k, v] for k, v in k_vs]


class TestLongForkChecker:
    def c(self, ops):
        return long_fork.checker(2).check({}, hist(ops), {})

    def test_valid_order(self):
        res = self.c([
            op("ok", 0, "read", rt([(0, None), (1, None)])),
            op("ok", 1, "read", rt([(0, 1), (1, None)])),
            op("ok", 2, "read", rt([(0, 1), (1, 1)])),
        ])
        assert res["valid?"] is True
        assert res["reads-count"] == 3
        assert res["early-read-count"] == 1
        assert res["late-read-count"] == 1

    def test_long_fork_detected(self):
        res = self.c([
            op("ok", 0, "read", rt([(0, 1), (1, None)])),
            op("ok", 1, "read", rt([(0, None), (1, 1)])),
        ])
        assert res["valid?"] is False
        assert len(res["forks"]) == 1

    def test_multiple_writes_unknown(self):
        res = self.c([
            op("invoke", 0, "write", [["w", 0, 1]]),
            op("ok", 0, "write", [["w", 0, 1]]),
            op("invoke", 1, "write", [["w", 0, 1]]),
            op("ok", 1, "write", [["w", 0, 1]]),
        ])
        assert res["valid?"] == "unknown"
        assert res["error"] == ["multiple-writes", 0]

    def test_group_for(self):
        assert list(long_fork.group_for(2, 5)) == [4, 5]
        assert list(long_fork.group_for(3, 7)) == [6, 7, 8]

    def test_read_compare(self):
        assert long_fork.read_compare({0: 1, 1: None},
                                      {0: 1, 1: None}) == 0
        assert long_fork.read_compare({0: 1, 1: None},
                                      {0: None, 1: None}) == -1
        assert long_fork.read_compare({0: None}, {0: 1}) == 1
        assert long_fork.read_compare({0: 1, 1: None},
                                      {0: None, 1: 1}) is None
        with pytest.raises(long_fork.IllegalHistory):
            long_fork.read_compare({0: 1}, {0: 2})


class LongForkMemClient(jclient.Client):
    """Serializable in-memory store for long-fork txns."""

    def __init__(self, state=None, lock=None):
        self.state = state if state is not None else {}
        self.lock = lock or threading.Lock()

    def open(self, test, node):
        return LongForkMemClient(self.state, self.lock)

    def invoke(self, test, o):
        with self.lock:
            out = []
            for f, k, v in o["value"]:
                if f == "w":
                    self.state[k] = v
                    out.append([f, k, v])
                else:
                    out.append([f, k, self.state.get(k)])
            return {**o, "type": "ok", "value": out}


def test_long_fork_end_to_end(tmp_path):
    w = long_fork.workload(2)
    t = {
        "name": "lf-e2e", "store_root": str(tmp_path),
        "nodes": ["n1", "n2"], "concurrency": 4,
        "ssh": {"dummy?": True},
        "client": LongForkMemClient(),
        "checker": w["checker"],
        "generator": gen.limit(80, w["generator"]),
    }
    res = core.run(t)
    assert res["results"]["valid?"] is True
    assert res["results"]["reads-count"] > 0


class TestCausalChecker:
    def c(self, ops):
        return causal.check().check({}, hist(ops), {})

    def test_valid_chain(self):
        res = self.c([
            op("ok", 0, "read-init", None, position=1, link="init"),
            op("ok", 0, "write", 1, position=2, link=1),
            op("ok", 0, "read", 1, position=3, link=2),
            op("ok", 0, "write", 2, position=4, link=3),
            op("ok", 0, "read", 2, position=5, link=4),
        ])
        assert res["valid?"] is True

    def test_broken_link(self):
        res = self.c([
            op("ok", 0, "read-init", None, position=1, link="init"),
            op("ok", 0, "write", 1, position=2, link=99),
        ])
        assert res["valid?"] is False
        assert "Cannot link" in res["error"]

    def test_wrong_write_value(self):
        res = self.c([
            op("ok", 0, "read-init", None, position=1, link="init"),
            op("ok", 0, "write", 5, position=2, link=1),
        ])
        assert res["valid?"] is False
        assert "expected value 1" in res["error"]

    def test_bad_init_read(self):
        res = self.c([
            op("ok", 0, "read-init", 7, position=1, link="init"),
        ])
        assert res["valid?"] is False
        assert "init value" in res["error"]

    def test_stale_read(self):
        res = self.c([
            op("ok", 0, "read-init", None, position=1, link="init"),
            op("ok", 0, "write", 1, position=2, link=1),
            op("ok", 0, "read", 0, position=3, link=2),
        ])
        assert res["valid?"] is False
        assert "can't read" in res["error"]


class TestCausalReverse:
    def c(self, ops):
        return causal_reverse.checker().check({}, hist(ops), {})

    def test_valid(self):
        res = self.c([
            op("invoke", 0, "write", 1), op("ok", 0, "write", 1),
            op("invoke", 1, "write", 2), op("ok", 1, "write", 2),
            op("invoke", 2, "read", None),
            op("ok", 2, "read", [1, 2]),
        ])
        assert res["valid?"] is True

    def test_t2_without_t1(self):
        res = self.c([
            op("invoke", 0, "write", 1), op("ok", 0, "write", 1),
            op("invoke", 1, "write", 2), op("ok", 1, "write", 2),
            op("invoke", 2, "read", None),
            op("ok", 2, "read", [2]),
        ])
        assert res["valid?"] is False
        assert res["errors"][0]["missing"] == [1]
        assert res["errors"][0]["expected-count"] == 1

    def test_concurrent_writes_ok_either_way(self):
        res = self.c([
            op("invoke", 0, "write", 1),
            op("invoke", 1, "write", 2),
            op("ok", 0, "write", 1), op("ok", 1, "write", 2),
            op("invoke", 2, "read", None),
            op("ok", 2, "read", [2]),
        ])
        assert res["valid?"] is True


class TestAdyaG2:
    def c(self, ops):
        return adya.g2_checker().check({}, hist(ops), {})

    def test_single_insert_ok(self):
        res = self.c([
            op("invoke", 0, "insert", KV(0, [None, 1])),
            op("ok", 0, "insert", KV(0, [None, 1])),
            op("invoke", 1, "insert", KV(0, [2, None])),
            op("fail", 1, "insert", KV(0, [2, None])),
        ])
        assert res["valid?"] is True
        assert res["key-count"] == 1
        assert res["legal-count"] == 1

    def test_double_insert_illegal(self):
        res = self.c([
            op("ok", 0, "insert", KV(3, [None, 1])),
            op("ok", 1, "insert", KV(3, [2, None])),
        ])
        assert res["valid?"] is False
        assert res["illegal"] == {3: 2}

    def test_generator_emits_unique_id_pairs(self):
        g = gen.limit(12, adya.g2_gen())
        ctx = testlib.n_nemesis_context(4)
        ops = [o for o in testlib.quick(g, ctx=ctx)
               if o.get("f") == "insert"]
        assert len(ops) >= 4
        ids = [x for o in ops for x in o["value"].v if x is not None]
        assert len(ids) == len(set(ids))
        by_key: dict = {}
        for o in ops:
            by_key.setdefault(o["value"].k, []).append(o["value"].v)
        for k, vs in by_key.items():
            assert len(vs) <= 2


class SetMemClient(jclient.Client):
    def __init__(self, state=None, lock=None, lose_every=None):
        self.state = state if state is not None else set()
        self.lock = lock or threading.Lock()
        self.lose_every = lose_every

    def open(self, test, node):
        return SetMemClient(self.state, self.lock, self.lose_every)

    def invoke(self, test, o):
        with self.lock:
            if o["f"] == "add":
                if self.lose_every and o["value"] % self.lose_every == 0:
                    return {**o, "type": "ok"}  # ack but drop
                self.state.add(o["value"])
                return {**o, "type": "ok"}
            return {**o, "type": "ok", "value": sorted(self.state)}


def test_set_workload_end_to_end(tmp_path):
    w = sets.workload({"time_limit": 2})
    t = {
        "name": "set-e2e", "store_root": str(tmp_path),
        "nodes": ["n1", "n2"], "concurrency": 2,
        "ssh": {"dummy?": True},
        "client": SetMemClient(),
        **w,
    }
    res = core.run(t)
    assert res["results"]["valid?"] is True
    assert res["results"]["set"]["ok-count"] > 0


def test_set_workload_detects_lost(tmp_path):
    w = sets.workload({"time_limit": 2})
    t = {
        "name": "set-lost", "store_root": str(tmp_path),
        "nodes": ["n1"], "concurrency": 1,
        "ssh": {"dummy?": True},
        "client": SetMemClient(lose_every=3),
        **w,
    }
    res = core.run(t)
    assert res["results"]["valid?"] is False
    assert res["results"]["set"]["lost-count"] > 0


def test_causal_workload_emits_canonical_order():
    w = causal.workload({"time_limit": 30})
    ops = testlib.quick(w["generator"], ctx=testlib.n_nemesis_context(1))
    fs = [o["f"] for o in ops if o.get("process") != "nemesis"]
    assert fs[:5] == ["read-init", "write", "read", "write", "read"]
    vals = [getattr(o.get("value"), "v", None) for o in ops
            if o.get("process") != "nemesis"][:5]
    assert vals == [None, 1, None, 2, None]


def test_monotonic_valid():
    h = hist([
        op("ok", 0, "inc", {0: 1}),
        op("ok", 1, "read", {0: 1, 1: -1}),
        op("ok", 0, "inc", {1: 1}),
        op("ok", 1, "read", {0: 1, 1: 1}),
        op("ok", 0, "inc", {0: 2}),
        op("ok", 1, "read", {0: 2, 1: 1}),
    ])
    res = monotonic.checker().check({}, h, {})
    assert res["valid?"] is True


def test_monotonic_cycle_detected():
    h = hist([
        op("ok", 0, "read", {"x": 1, "y": 2}),
        op("ok", 1, "read", {"x": 2, "y": 1}),
    ])
    res = monotonic.checker().check({}, h, {})
    assert res["valid?"] is False
    assert "observed key" in res["explanation"]


def test_monotonic_generator_shape():
    w = monotonic.workload()
    ops = testlib.quick(gen.limit(30, w["generator"]),
                        ctx=testlib.n_nemesis_context(3))
    assert any(o["f"] == "inc" for o in ops)
    reads = [o for o in ops if o["f"] == "read"]
    assert reads and all(len(o["value"]) <= 3 for o in reads)


def test_monotonic_tied_values_dont_swallow_edges():
    h = hist([
        op("ok", 0, "read", {"x": 1, "y": 2}),
        op("ok", 1, "read", {"x": 1}),
        op("ok", 2, "read", {"x": 2, "y": 1}),
    ])
    res = monotonic.checker().check({}, h, {})
    assert res["valid?"] is False


def test_monotonic_hub_edges_scale_and_explain():
    ops = [op("ok", 0, "read", {"x": 1, "y": 5})]
    ops += [op("ok", 0, "read", {"x": 1}) for _ in range(39)]
    ops += [op("ok", 1, "read", {"x": 2}) for _ in range(39)]
    ops.append(op("ok", 1, "read", {"x": 2, "y": 3}))
    res = monotonic.checker().check({}, hist(ops), {})
    assert res["valid?"] is False
    assert all(n >= 0 for n in res["cycle"])
    assert "observed key" in res["explanation"]


# -- parity: the generators ---------------------------------------------------

def as_data(x):
    """Ops as dicts, [k v] tuples and models as tuples, recursively, so
    that both packages' values compare equal."""
    if isinstance(x, (Op, RefOp)):
        return as_data(x.to_dict())
    if isinstance(x, (KV, ref_independent.KV)):
        return ("KV", as_data(x.k), as_data(x.v))
    if isinstance(x, (causal.CausalRegister, ref_causal.CausalRegister)):
        return ("CausalRegister", x.value, x.counter, x.last_pos)
    if isinstance(x, dict):
        return {as_data(k): as_data(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(as_data(v) for v in x)
    if isinstance(x, (set, frozenset)):
        return type(x)(as_data(v) for v in x)
    return x


GENERATORS = {
    "sets": (lambda m: m.adds(), 4, 40),
    "long_fork": (lambda m: m.workload(2)["generator"], 4, 60),
    "adya": (lambda m: m.g2_gen(), 4, 40),
    "causal": (lambda m: m.workload({"time_limit": 30})["generator"], 2,
               40),
    "causal_reverse": (lambda m: m.workload({"nodes": ["n1", "n2"],
                                             "per_key_limit": 20})
                       ["generator"], 4, 60),
    "monotonic": (lambda m: m.generator(), 3, 60),
}
PORT = {"sets": sets, "long_fork": long_fork, "adya": adya,
        "causal": causal, "causal_reverse": causal_reverse,
        "monotonic": monotonic}
REF = {"sets": ref_sets, "long_fork": ref_long_fork, "adya": ref_adya,
       "causal": ref_causal, "causal_reverse": ref_causal_reverse,
       "monotonic": ref_monotonic}


@pytest.mark.parametrize("seed", (0, 1))
@pytest.mark.parametrize("name", sorted(GENERATORS))
def test_generator_matches_reference(name, seed):
    """Each generator, seeded alike in both packages (and with fresh
    ids: `adya`'s `_Ids` is made by each `g2_gen` call), gives the same
    first ops, a perfect client completing each."""
    make, n, limit = GENERATORS[name]

    def first_ops(gen_mod, testlib_mod, mod):
        gen_mod.RNG.seed(seed)
        return testlib_mod.simulate(
            gen_mod.limit(limit, make(mod)),
            lambda c, inv: {**inv, "type": "ok"},
            testlib_mod.n_nemesis_context(n))

    port = first_ops(gen, testlib, PORT[name])
    ref = first_ops(ref_gen, ref_testlib, REF[name])
    assert as_data(port) == as_data(ref)
    assert sum(1 for o in port if o["type"] == "invoke") >= limit // 2


# -- parity: the checkers on seeded histories -------------------------------

def ref_history(ops):
    """The port's ops as the reference's indexed History, the [k v]
    tuples made the reference's."""
    out = []
    for o in ops:
        d = o.to_dict()
        if isinstance(o.value, KV):
            d["value"] = ref_independent.KV(o.value.k, o.value.v)
        out.append(RefOp.from_dict(d))
    return RefHistory(out).index()


# the fan-out's wall-clock fields (`independent.checker`'s "shard" and
# "util" blocks), which no two runs share
WALL_CLOCK = ("t0", "wall_s", "busy_frac", "span_s", "straggler_ratio")


def untimed(x):
    if isinstance(x, dict):
        return {k: untimed(v) for k, v in x.items() if k not in WALL_CLOCK}
    if isinstance(x, list):
        return [untimed(v) for v in x]
    return x


def both(make_checker, ops, test=None):
    """A checker of each package (`make_checker(module_map)`) on the
    same ops: (port's result, reference's result), as data, the
    wall-clock fields left out."""
    test = test or {}
    port = make_checker(PORT).check(test, History(list(ops)).index(), {})
    ref = make_checker(REF).check(test, ref_history(ops), {})
    return untimed(as_data(port)), untimed(as_data(ref))


def set_history(seed: int, lose: bool) -> list:
    """Adds of 0..59 by 3 processes (ok, fail or info), then a final
    read by each: the acknowledged adds and half of the indefinite ones;
    `lose` drops one acknowledged add from every read."""
    rng = np.random.RandomState(seed)
    ops, t, stored, acked = [], 0, set(), []
    for v in range(60):
        p = v % 3
        ops.append(op("invoke", p, "add", v, time=t))
        r = rng.rand()
        typ = "ok" if r < 0.8 else ("fail" if r < 0.9 else "info")
        ops.append(op(typ, p, "add", v, time=t + 1))
        if typ == "ok":
            stored.add(v)
            acked.append(v)
        elif typ == "info" and rng.rand() < 0.5:
            stored.add(v)
        t += 2
    if lose:
        stored.discard(acked[int(rng.randint(len(acked)))])
    for p in range(3):
        ops.append(op("invoke", p, "read", None, time=t))
        ops.append(op("ok", p, "read", sorted(stored), time=t + 1))
        t += 2
    return ops


@pytest.mark.parametrize("lose", (False, True))
@pytest.mark.parametrize("seed", (0, 1, 2))
def test_sets_checker_matches_reference(seed, lose):
    port, ref = both(lambda m: m["sets"].workload()["checker"],
                     set_history(seed, lose))
    assert port == ref
    assert port["valid?"] is (not lose)
    assert port["set"]["lost-count"] == (1 if lose else 0)


def long_fork_history(seed: int, fork: bool) -> list:
    """Writes of keys 0..15 (groups of 2) and group reads, run one at a
    time against a serial store; `fork` adds two reads of group {0, 1}
    that see one key each (x without y, y without x)."""
    rng = np.random.RandomState(seed)
    ops, t, state = [], 0, {}
    keys = [int(k) for k in rng.permutation(16)]
    n_reads = 0
    while keys or n_reads < 24:
        p = int(rng.randint(4))
        if keys and rng.rand() < 0.5:
            k = keys.pop()
            txn = [["w", k, 1]]
            ops.append(op("invoke", p, "write", txn, time=t))
            state[k] = 1
            ops.append(op("ok", p, "write", txn, time=t + 1))
        else:
            g = [int(k) for k in rng.permutation(
                list(long_fork.group_for(2, int(rng.randint(16)))))]
            ops.append(op("invoke", p, "read", [["r", k, None] for k in g],
                          time=t))
            ops.append(op("ok", p, "read",
                          [["r", k, state.get(k)] for k in g], time=t + 1))
            n_reads += 1
        t += 2
    if fork:
        for p, seen in ((0, 0), (1, 1)):
            ops.append(op("invoke", p, "read", rt([(0, None), (1, None)]),
                          time=t))
            ops.append(op("ok", p, "read",
                          rt([(k, 1 if k == seen else None)
                              for k in (0, 1)]), time=t + 1))
            t += 2
    return ops


@pytest.mark.parametrize("fork", (False, True))
@pytest.mark.parametrize("seed", (0, 1, 2))
def test_long_fork_checker_matches_reference(seed, fork):
    ops = long_fork_history(seed, fork)
    port, ref = both(lambda m: m["long_fork"].checker(2), ops)
    assert port == ref
    assert port["valid?"] is (not fork)
    if fork:
        assert port["forks"]


def adya_history(seed: int, g2: bool) -> list:
    """Two concurrent inserts a key (ids unique), at most one of them
    ok, the other failed or indefinite; `g2` lets both succeed on one
    key."""
    rng = np.random.RandomState(seed)
    ops, t, ids = [], 0, iter(range(1, 1000))
    bad = int(rng.randint(12))
    for k in range(12):
        a, b = KV(k, [None, next(ids)]), KV(k, [next(ids), None])
        ops += [op("invoke", 2 * k, "insert", a, time=t),
                op("invoke", 2 * k + 1, "insert", b, time=t + 1)]
        winner = int(rng.randint(2))
        loser = "fail" if rng.rand() < 0.7 else "info"
        types = ["ok", loser] if winner == 0 else [loser, "ok"]
        if g2 and k == bad:
            types = ["ok", "ok"]
        ops += [op(types[0], 2 * k, "insert", a, time=t + 2),
                op(types[1], 2 * k + 1, "insert", b, time=t + 3)]
        t += 4
    return ops


@pytest.mark.parametrize("g2", (False, True))
@pytest.mark.parametrize("seed", (0, 1, 2))
def test_adya_checker_matches_reference(seed, g2):
    port, ref = both(lambda m: m["adya"].workload()["checker"],
                     adya_history(seed, g2))
    assert port == ref
    assert port["valid?"] is (not g2)
    assert port["illegal-count"] == (1 if g2 else 0)


def key_ops(ops, k) -> list:
    """Key k's ops with their [k v] tuples unwrapped, as copies."""
    return [Op.from_dict({**o.to_dict(), "value": o.value.v})
            for o in ops if o.value.k == k]


CAUSAL_ORDER = (("read-init", None), ("write", 1), ("read", 1),
                ("write", 2), ("read", 2))


def causal_history(seed: int, broken: bool) -> list:
    """Each of 6 keys runs the canonical causal order on its own process
    (position and link fields chained), the keys' ops interleaved;
    `broken` gives one key a stale read or a bad link."""
    rng = np.random.RandomState(seed)
    steps = {k: 0 for k in range(6)}
    bad_key, bad_step = int(rng.randint(6)), 2 + int(rng.randint(3))
    ops, t = [], 0
    while any(s < 5 for s in steps.values()):
        k = int(rng.choice([k for k, s in steps.items() if s < 5]))
        s = steps[k]
        f, v = CAUSAL_ORDER[s]
        pos, link = 10 * k + s + 1, ("init" if s == 0 else 10 * k + s)
        if broken and k == bad_key and s == bad_step:
            if f == "write":
                link = 99
            else:
                v = 0
        ops.append(op("invoke", k, f, KV(k, None if f != "write" else v),
                      time=t, position=pos, link=link))
        ops.append(op("ok", k, f, KV(k, v), time=t + 1, position=pos,
                      link=link))
        steps[k] += 1
        t += 2
    return ops


@pytest.mark.parametrize("broken", (False, True))
@pytest.mark.parametrize("seed", (0, 1, 2))
def test_causal_checker_matches_reference(seed, broken):
    ops = causal_history(seed, broken)
    port, ref = both(lambda m: m["causal"].workload({})["checker"], ops)
    assert port == ref
    assert port["valid?"] is (not broken)
    for k in range(6):
        port, ref = both(lambda m: m["causal"].check(), key_ops(ops, k))
        assert port == ref


def causal_reverse_history(seed: int, missing: bool) -> list:
    """Per key, blind writes of distinct values and reads of the whole
    set, some writes concurrent, the reads against a serial store;
    `missing` drops from one late read a value acknowledged before a
    value it saw was written."""
    rng = np.random.RandomState(seed)
    ops, t = [], 0
    for k in range(3):
        stored, pending, nxt = [], [], 0
        for _ in range(30):
            p = 4 * k + int(rng.randint(4))
            if pending and (rng.rand() < 0.5 or len(pending) > 2):
                pp, v = pending.pop(0)
                stored.append(v)
                ops.append(op("ok", pp, "write", KV(k, v), time=t))
            elif rng.rand() < 0.5 and p not in [q for q, _ in pending]:
                ops.append(op("invoke", p, "write", KV(k, nxt), time=t))
                pending.append((p, nxt))
                nxt += 1
            elif p not in [q for q, _ in pending]:
                ops.append(op("invoke", p, "read", KV(k, None), time=t))
                ops.append(op("ok", p, "read", KV(k, sorted(stored)),
                              time=t + 1))
            t += 2
        for pp, v in pending:
            stored.append(v)
            ops.append(op("ok", pp, "write", KV(k, v), time=t))
            t += 2
        p = 4 * k
        seen = sorted(stored)
        if missing and k == 1:
            seen = seen[1:]
        ops.append(op("invoke", p, "read", KV(k, None), time=t))
        ops.append(op("ok", p, "read", KV(k, seen), time=t + 1))
        t += 2
    return ops


@pytest.mark.parametrize("missing", (False, True))
@pytest.mark.parametrize("seed", (0, 1, 2))
def test_causal_reverse_checker_matches_reference(seed, missing):
    ops = causal_reverse_history(seed, missing)
    port, ref = both(lambda m: independent.checker(
        m["causal_reverse"].checker()) if m is PORT else
        ref_independent.checker(m["causal_reverse"].checker()), ops)
    assert port == ref
    assert port["valid?"] is (not missing)
    port, ref = both(lambda m: m["causal_reverse"].checker(),
                     key_ops(ops, 1))
    assert port == ref
    assert port["valid?"] is (not missing)


def monotonic_history(seed: int, cycle: bool) -> list:
    """Increments of one or two of 5 keys and reads of 3, run against a
    serial store (missing keys read -1); `cycle` swaps two late reads'
    values of one key, so that the key orders them against another."""
    rng = np.random.RandomState(seed)
    state = {k: 0 for k in range(5)}
    ops, t = [], 0
    for i in range(80):
        p = int(rng.randint(4))
        if rng.rand() < 0.6:
            ks = sorted(int(k) for k in rng.choice(5, 1 + int(rng.rand() <
                                                            0.3),
                                                   replace=False))
            for k in ks:
                state[k] += 1
            f, value = "inc", {k: state[k] for k in ks}
        else:
            ks = sorted(int(k) for k in rng.choice(5, 3, replace=False))
            f, value = "read", {k: (state[k] or -1) for k in ks}
        ops.append(op("invoke", p, f, {k: None for k in ks}, time=t))
        ops.append(op("ok", p, f, value, time=t + 1))
        t += 2
    if cycle:
        ops.append(op("invoke", 0, "read", {0: None, 1: None}, time=t))
        ops.append(op("ok", 0, "read", {0: state[0] + 1, 1: state[1]},
                      time=t + 1))
        ops.append(op("invoke", 1, "read", {0: None, 1: None}, time=t + 2))
        ops.append(op("ok", 1, "read", {0: state[0], 1: state[1] + 1},
                      time=t + 3))
    return ops


@pytest.mark.parametrize("cycle", (False, True))
@pytest.mark.parametrize("seed", (0, 1, 2))
def test_monotonic_checker_matches_reference(seed, cycle):
    port, ref = both(lambda m: m["monotonic"].workload()["checker"],
                     monotonic_history(seed, cycle))
    assert port == ref
    assert port["valid?"] is (not cycle)
    if cycle:
        assert port["cycle"] and "observed key" in port["explanation"]
