"""The port's checker compositions against the JAX package's.

Each ported checker (`compose`, `stats`, `unhandled_exceptions`,
`unbridled_optimism`, `concurrency_limit`, `queue`, `set_checker`,
`total_queue`, `unique_ids`, `counter`, `set_full`, `log_file_pattern`)
runs on the same seeded histories (numpy, one case per checker and
input) in both packages and must return the same result dict, exactly;
ops and models inside a result are compared as their dicts and reprs.
"""

import numpy as np
import pytest

from jepsen_tpu import checker as jchecker
from jepsen_tpu import history as jh
from jepsen_tpu import store as jstore
from jepsen_tpu.models import core as jmodels
from jepsen_tpu_torch import checker as tchecker
from jepsen_tpu_torch import history as th
from jepsen_tpu_torch.models import core as tmodels

ERRORS = ("timeout", "conn-refused", "Crash")


def norm(x):
    """A result as plain data: ops as their dicts, models as reprs."""
    if hasattr(x, "to_dict"):
        return ("op", x.to_dict())
    if isinstance(x, dict):
        return {k: norm(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [norm(v) for v in x]
    if isinstance(x, (jmodels.Model, tmodels.Model)):
        return repr(x)
    return x


def workload(kind: str, seed: int, n: int = 160) -> list:
    """A concurrent history of op dicts: processes invoke and complete
    in a random interleaving; a crashed (info) process comes back under
    a fresh id, as Jepsen's interpreter does. Seed 1 injects no
    anomaly (no lost, duplicated or unexpected element, no wrong read)."""
    rng = np.random.default_rng(seed)
    noisy = seed != 1
    procs = list(range(4))
    next_proc = 4
    pending: dict = {}
    ops: list = []
    t = 0
    state = {"enq": [], "added": [], "next": 0, "sum": 0}

    def emit(typ, f, proc, value, **extra):
        nonlocal t
        t += int(rng.integers(1, 3_000_000))
        ops.append({"type": typ, "f": f, "process": proc, "value": value,
                    "time": t, **extra})

    def invoke(proc):
        if kind == "queue":
            f = "enqueue" if rng.random() < 0.55 else "dequeue"
            v = None
            if f == "enqueue":
                v = state["next"]
                state["next"] += 1
        elif kind == "set":
            f = "add" if rng.random() < 0.7 else "read"
            v = None
            if f == "add":
                v = state["next"]
                state["next"] += 1
        elif kind == "counter":
            f = "add" if rng.random() < 0.6 else "read"
            v = int(rng.integers(0, 5)) if f == "add" else None
        elif kind == "ids":
            f, v = "generate", None
        else:                          # cas
            f = ("read", "write", "cas")[int(rng.integers(0, 3))]
            v = (None if f == "read" else int(rng.integers(0, 5))
                 if f == "write" else [int(rng.integers(0, 5)),
                                       int(rng.integers(0, 5))])
        pending[proc] = (f, v)
        emit("invoke", f, proc, v)

    def complete(proc):
        nonlocal next_proc
        f, v = pending.pop(proc)
        r = rng.random()
        typ = "ok" if r < 0.8 else "fail" if r < 0.9 else "info"
        out = v
        if kind == "queue" and f == "enqueue" and typ != "fail":
            if typ == "ok" or rng.random() < 0.5:
                state["enq"].append(v)
        if kind == "queue" and f == "dequeue" and typ == "ok":
            if state["enq"] and (not noisy or rng.random() < 0.9):
                out = state["enq"].pop(int(rng.integers(0, len(
                    state["enq"]))))
                if noisy and rng.random() < 0.05:
                    state["enq"].append(out)      # a duplicate delivery
            elif noisy and rng.random() < 0.5:
                out = 10_000 + int(rng.integers(0, 3))  # unexpected
            else:
                typ = "fail"
        if kind == "set":
            if f == "add" and typ == "ok":
                state["added"].append(v)
            elif f == "add" and typ == "info" and rng.random() < 0.5:
                state["added"].append(v)
            elif f == "read" and typ == "ok":
                seen = [x for x in state["added"]
                        if not noisy or rng.random() < 0.93]
                if noisy and rng.random() < 0.1:
                    seen.append(5_000 + int(rng.integers(0, 2)))
                if seen and noisy and rng.random() < 0.05:
                    seen.append(seen[0])          # a duplicate in one read
                out = seen
        if kind == "counter":
            if f == "add" and typ == "ok":
                state["sum"] += v
            elif f == "read" and typ == "ok":
                out = state["sum"] + (int(rng.integers(-2, 3))
                                      if noisy and rng.random() < 0.1
                                      else 0)
        if kind == "ids" and typ == "ok":
            out = state["next"]
            state["next"] += 1
            if noisy and rng.random() < 0.05:
                out = int(rng.integers(0, max(1, state["next"])))
        extra = {}
        if typ == "info":
            e = ERRORS[int(rng.integers(0, len(ERRORS)))]
            extra = {"error": e}
            if rng.random() < 0.3:
                extra = {"exception": e.upper()}
        emit(typ, f, proc, out, **extra)
        if typ == "info":
            procs[procs.index(proc)] = next_proc
            next_proc += 1

    for _ in range(n):
        idle = [p for p in procs if p not in pending]
        if idle and (not pending or rng.random() < 0.5):
            invoke(idle[int(rng.integers(0, len(idle)))])
        else:
            busy = sorted(pending)
            complete(busy[int(rng.integers(0, len(busy)))])
        if rng.random() < 0.03:
            emit("info", "start" if rng.random() < 0.5 else "stop",
                 "nemesis", None)
    for p in sorted(pending):
        complete(p)
    if kind == "queue":
        left = list(state["enq"])
        rng.shuffle(left)
        if rng.random() < 0.5:
            emit("invoke", "drain", 0 if 0 in procs else procs[0], None)
            emit("ok", "drain", 0 if 0 in procs else procs[0],
                 [int(x) for x in left])
        else:
            emit("invoke", "drain", procs[0], None)
            emit("info", "drain", procs[0], [int(x) for x in left[:3]])
    if kind == "set":
        emit("invoke", "read", procs[0], None)
        emit("ok", "read", procs[0],
             [x for x in state["added"]
              if not noisy or rng.random() < 0.95])
    for i, o in enumerate(ops):
        o["index"] = i
    return ops


def both(ops):
    return (jh.History([jh.Op.from_dict(dict(o)) for o in ops]),
            th.History([th.Op.from_dict(dict(o)) for o in ops]))


def _raises(test, history, opts):
    raise ValueError("this checker always raises")


def compose_of(mod):
    return mod.compose({"stats": mod.stats(),
                        "optimism": mod.unbridled_optimism(),
                        "exceptions": mod.unhandled_exceptions(),
                        "broken": mod.FnChecker(_raises)})


CHECKERS = {
    "compose": (compose_of, "cas"),
    "stats": (lambda m: m.stats(), "cas"),
    "unhandled_exceptions": (lambda m: m.unhandled_exceptions(), "cas"),
    "unbridled_optimism": (lambda m: m.unbridled_optimism(), "cas"),
    "concurrency_limit": (lambda m: m.concurrency_limit(
        1, m.compose({"stats": m.stats(), "counter": m.counter()})),
        "counter"),
    "queue": (lambda m: m.queue(), "queue"),
    "set_checker": (lambda m: m.set_checker(), "set"),
    "total_queue": (lambda m: m.total_queue(), "queue"),
    "unique_ids": (lambda m: m.unique_ids(), "ids"),
    "counter": (lambda m: m.counter(), "counter"),
    "set_full": (lambda m: m.set_full(), "set"),
    "set_full_linearizable": (lambda m: m.set_full(linearizable=True),
                              "set"),
}
CASES = [(name, seed) for name in CHECKERS for seed in (1, 2, 3)]


def drop_tracebacks(res):
    """check_safe's traceback text names each package's files."""
    if isinstance(res, dict):
        return {k: ("<traceback>" if k == "error" and isinstance(v, str)
                    and v.startswith("Traceback") else drop_tracebacks(v))
                for k, v in res.items()}
    return res


@pytest.mark.parametrize("name,seed", CASES,
                         ids=[f"{n}-{s}" for n, s in CASES])
def test_checker_matches_reference(name, seed):
    make, kind = CHECKERS[name]
    jhist, thist = both(workload(kind, seed))
    test = {"name": "compose"}
    want = jchecker.check_safe(make(jchecker), test, jhist, {})
    got = tchecker.check_safe(make(tchecker), test, thist, {})
    assert norm(drop_tracebacks(got)) == norm(drop_tracebacks(want))
    if name == "compose":
        assert got["broken"]["fault"] == want["broken"]["fault"]
        assert got["broken"]["valid?"] == "unknown"


def test_the_cases_are_not_all_trivial():
    """The seeded inputs reach both verdicts across the checkers."""
    verdicts = set()
    for name, seed in CASES:
        make, kind = CHECKERS[name]
        _, thist = both(workload(kind, seed))
        verdicts.add(repr(tchecker.check_safe(make(tchecker), {}, thist,
                                              {})["valid?"]))
    assert {"True", "False"} <= verdicts


@pytest.mark.parametrize("kind", ["cas", "queue"])
def test_expand_queue_drain_ops_matches(kind):
    jhist, thist = both(workload("queue", 5) if kind == "queue"
                        else workload("cas", 5))
    assert [o.to_dict() for o in tchecker.expand_queue_drain_ops(thist)] \
        == [o.to_dict() for o in jchecker.expand_queue_drain_ops(jhist)]


def test_a_crashed_drain_without_elements_raises_in_both():
    ops = [{"type": "invoke", "f": "drain", "process": 0, "value": None},
           {"type": "info", "f": "drain", "process": 0, "value": None}]
    jhist, thist = both(ops)
    with pytest.raises(ValueError):
        jchecker.expand_queue_drain_ops(jhist)
    with pytest.raises(ValueError):
        tchecker.expand_queue_drain_ops(thist)


@pytest.mark.parametrize("points,values", [
    ((0, 0.5, 1), [5, 1, 3, 9]), ((0.95, 0.99), list(range(100))),
    ((0, 1), [])])
def test_frequency_distribution_matches(points, values):
    assert tchecker.frequency_distribution(points, values) == \
        jchecker.frequency_distribution(points, values)


@pytest.mark.parametrize("pattern", ["panic|ERROR", "nothing-matches"])
def test_log_file_pattern_matches(tmp_path, pattern):
    test = {"name": "logs", "start_time": "20260101T000000",
            "store_root": str(tmp_path), "nodes": ["n1", "n2", "n3"]}
    lines = {"n1": "ok\nERROR: disk full\nfine\n",
             "n2": "panic: nil map\npanic again\n"}
    for node, text in lines.items():
        p = jstore.path_bang(test, node, "db.log")
        with open(p, "w") as fh:
            fh.write(text)
    want = jchecker.log_file_pattern(pattern, "db.log").check(test, None)
    got = tchecker.log_file_pattern(pattern, "db.log").check(test, None)
    assert got == want
    assert got["valid?"] is (pattern == "nothing-matches")


def test_the_port_checkers_share_the_base():
    from jepsen_tpu_torch import independent as tind
    for c in (tchecker.linearizable(device="cpu"), tchecker.stats(),
              tchecker.compose({}), tind.checker(tchecker.stats()),
              tind.cuda_checker(tmodels.cas_register(), device="cpu")):
        assert isinstance(c, tchecker.Checker)
    h = th.History([th.invoke(0, "read", None), th.ok(0, "read", 1)])
    assert tchecker.stats()({}, h) == tchecker.stats().check({}, h, {})
