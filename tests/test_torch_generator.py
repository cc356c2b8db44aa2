"""The port's generator DSL against the JAX package's, case by case.

Every case of `tests/test_generator.py` (and a few combinators it does
not reach: `trace`, `ignore_updates`, `on_threads`, `concat`,
`synchronize`, the `test` command's demo workload) is built once per
package from that package's own `generator` module and run through that
package's own `generator.testlib` simulation (`simulate` / `quick` /
`perfect` / `perfect_info` / `imperfect`), each under its own
`RAND_SEED` (`with_seed` of its own module RNG). The op lists must be
equal: types, functions, values, processes and times.
"""

import re
from collections import Counter

import pytest

import jepsen_tpu.generator as ref_gen
import jepsen_tpu.generator.testlib as ref_gt
import jepsen_tpu_torch.generator as port_gen
import jepsen_tpu_torch.generator.testlib as port_gt

PACKAGES = {"ref": (ref_gen, ref_gt), "port": (port_gen, port_gt)}


def _norm(x):
    """A value with tuple values and sets made comparable across the
    two packages."""
    if hasattr(x, "k") and hasattr(x, "v"):
        return ("KV", _norm(x.k), _norm(x.v))
    if isinstance(x, dict):
        return {k: _norm(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_norm(v) for v in x]
    if isinstance(x, (set, frozenset)):
        return sorted(map(repr, x))
    return x


def _mix3(gen):
    return gen.mix([gen.repeat({"value": v}) for v in range(3)])


def _demo(gen):
    """The `test` command's generator shape (`__main__.demo_test`), in
    virtual nanoseconds."""
    return gen.time_limit(2e-6, gen.clients(gen.stagger(2e-8, gen.mix([
        gen.repeat(lambda: {"f": "read"}),
        gen.repeat(lambda: {"f": "write", "value": gen.RNG.randrange(5)}),
        gen.repeat(lambda: {"f": "cas",
                            "value": [gen.RNG.randrange(5),
                                      gen.RNG.randrange(5)]})]))))


def _fn_gen(gen):
    calls = []

    def f():
        calls.append(1)
        return {"value": len(calls)} if len(calls) <= 3 else None
    return f


def _fn_gen_args(gen):
    def f(test, ctx):
        return {"value": ctx.time} if ctx.time < 1 else None
    return f


def _on_update(gen):
    seen = []

    def handler(this, test, ctx, event):
        seen.append(event.get("type"))
        return this
    return gen.on_update(handler, gen.limit(6, gen.repeat({"value": 1})))


# (case id, testlib runner, builder(gen) -> generator, context size)
CASES = [
    ("nil", "perfect", lambda g: None, None),
    ("map-once", "perfect", lambda g: {"f": "write"}, None),
    ("map-concurrent", "perfect", lambda g: g.repeat(6, {"f": "write"}),
     None),
    ("limit", "quick",
     lambda g: g.limit(2, g.repeat({"f": "write", "value": 1})), None),
    ("repeat-does-not-advance", "perfect",
     lambda g: g.repeat(3, [{"value": v} for v in range(10)]), None),
    ("delay", "perfect",
     lambda g: g.limit(5, g.delay(3e-9, g.repeat({"f": "w"}))), None),
    ("seq", "quick", lambda g: [{"value": 1}, {"value": 2}, {"value": 3}],
     None),
    ("on-update", "perfect", _on_update, None),
    ("fn", "quick", _fn_gen, None),
    ("fn-with-args", "perfect", _fn_gen_args, None),
    ("map", "quick",
     lambda g: g.map_(lambda o: {**o, "value": o["value"] * 2},
                      [{"value": 1}, {"value": 2}]), None),
    ("f-map", "quick",
     lambda g: g.f_map({"start": "kill"}, [{"f": "start"}, {"f": "other"}]),
     None),
    ("filter", "quick",
     lambda g: g.limit(3, g.filter_(lambda o: o["value"] % 2 == 0,
                                    [{"value": v} for v in range(10)])),
     None),
    ("any", "quick",
     lambda g: g.any_([{"f": "slow", "time": 20}, {"f": "slow", "time": 40}],
                      g.limit(2, g.repeat({"f": "fast"}))), None),
    ("mix", "quick", lambda g: g.limit(300, _mix3(g)), None),
    ("once", "quick", lambda g: g.once(g.repeat({"f": "w"})), None),
    ("cycle", "quick", lambda g: g.cycle(2, [{"value": 1}, {"value": 2}]),
     None),
    ("time-limit", "perfect",
     lambda g: g.time_limit(25e-9, g.delay(10e-9, g.repeat({"f": "w"}))),
     None),
    ("stagger", "perfect",
     lambda g: g.limit(20, g.stagger(5e-9, g.repeat({"f": "w"}))), None),
    ("phases", "perfect_star",
     lambda g: g.phases(g.limit(4, g.repeat({"f": "a"})),
                        g.limit(1, g.repeat({"f": "b"}))), None),
    ("synchronize", "perfect_star",
     lambda g: [g.limit(3, g.repeat({"f": "a"})),
                g.synchronize(g.limit(2, g.repeat({"f": "b"})))], None),
    ("then", "quick",
     lambda g: g.then(g.once({"f": "read"}),
                      g.limit(3, g.repeat({"f": "write"}))), None),
    ("until-ok", "imperfect", lambda g: g.until_ok(g.repeat({"f": "w"})),
     None),
    ("flip-flop", "quick",
     lambda g: g.flip_flop(g.repeat([{"f": "a"}]),
                           g.limit(2, g.repeat({"f": "b"}))), None),
    ("flip-flop-updates", "imperfect",
     lambda g: g.limit(40, g.flip_flop(g.until_ok(g.repeat({"f": "w"})),
                                       g.repeat({"f": "r"}))), None),
    ("process-limit", "perfect_info",
     lambda g: g.process_limit(5, g.clients(g.repeat({"f": "w"}))), 2),
    ("clients", "quick",
     lambda g: g.limit(10, g.clients(g.repeat({"f": "w"}))), None),
    ("nemesis", "quick",
     lambda g: g.limit(3, g.nemesis(g.repeat({"f": "split"}))), None),
    ("clients-and-nemesis", "quick",
     lambda g: g.limit(30, g.clients(g.repeat({"f": "w"}),
                                     g.repeat({"f": "split"}))), None),
    ("each-thread", "quick",
     lambda g: g.each_thread([{"value": 1}, {"value": 2}]), None),
    ("reserve", "quick",
     lambda g: g.limit(40, g.clients(g.reserve(
         2, g.repeat({"f": "read"}), g.repeat({"f": "write"})))), 4),
    ("cycle-times", "perfect",
     lambda g: g.time_limit(40e-9, g.cycle_times(
         10e-9, g.repeat({"f": "a"}), 10e-9, g.repeat({"f": "b"}))), None),
    ("log-and-sleep", "quick_ops",
     lambda g: g.clients([g.log("hello"), g.sleep(1),
                          g.once(g.repeat({"f": "w"}))]), 1),
    ("determinism", "perfect",
     lambda g: g.limit(50, g.stagger(3e-9, _mix3(g))), None),
    ("perfect-info-rotates", "perfect_info",
     lambda g: g.limit(6, g.clients(g.repeat({"f": "w"}))), None),
    ("trace", "quick",
     lambda g: g.trace("t", g.limit(3, g.repeat({"f": "w"}))), None),
    ("ignore-updates", "imperfect",
     lambda g: g.limit(8, g.ignore_updates(g.until_ok(
         g.repeat({"f": "w"})))), None),
    ("on-threads", "quick",
     lambda g: g.limit(6, g.on_threads(lambda t: t != g.NEMESIS,
                                       g.repeat({"f": "w"}))), 3),
    ("concat", "quick",
     lambda g: g.concat(g.limit(2, g.repeat({"f": "a"})),
                        g.limit(2, g.repeat({"f": "b"}))), None),
    ("demo-workload", "perfect", _demo, 10),
    ("demo-workload-info", "imperfect", _demo, 5),
]


def _run(pkg, runner, build, n):
    gen, gt = PACKAGES[pkg]
    ctx = gt.n_nemesis_context(n) if n is not None else None
    return getattr(gt, runner)(build(gen), ctx)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_simulation_matches_reference(case):
    _, runner, build, n = case
    want = _norm(_run("ref", runner, build, n))
    got = _norm(_run("port", runner, build, n))
    assert got == want


def test_simulations_are_not_trivial(monkeypatch):
    """The cases do exercise the scheduler: the RNG-driven ones differ
    from one seed to another, and the demo mix has every op type."""
    out = _run("port", "perfect", _demo, 10)
    assert Counter(o["f"] for o in out).keys() == {"read", "write", "cas"}
    mix = lambda g: g.limit(300, _mix3(g))  # noqa: E731
    a = _norm(_run("port", "quick", mix, None))
    monkeypatch.setattr(port_gt, "RAND_SEED", port_gt.RAND_SEED + 1)
    assert _norm(_run("port", "quick", mix, None)) != a


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_module_rngs_are_separate(pkg):
    """Seeding one package's RNG leaves the other's stream alone."""
    gen, _ = PACKAGES[pkg]
    other = port_gen if gen is ref_gen else ref_gen
    state = other.RNG.getstate()
    with gen.with_seed(7):
        gen.RNG.random()
    assert other.RNG.getstate() == state


def _bad_process(gen):
    class Bad(gen.Generator):
        def op(self, test, ctx):
            return ({"type": "invoke", "f": "w", "process": 99, "time": 0},
                    self)
    return Bad()


def _bad_type(gen):
    class Bad(gen.Generator):
        def op(self, test, ctx):
            p = ctx.some_free_process()
            return ({"type": "wat", "f": "w", "process": p, "time": 0}, self)
    return Bad()


def _boom(gen):
    class Boom(gen.Generator):
        def op(self, test, ctx):
            raise ValueError("boom")
    return gen.friendly_exceptions(Boom())


@pytest.mark.parametrize("build,exc", [
    (_bad_process, "InvalidOp"), (_bad_type, "InvalidOp"),
    (_boom, "RuntimeError")], ids=["busy-process", "bad-type", "friendly"])
def test_invalid_ops_raise_as_the_reference(build, exc):
    msgs = []
    for pkg in ("ref", "port"):
        gen, gt = PACKAGES[pkg]
        with pytest.raises(Exception) as ei:
            gt.quick(build(gen))
        assert type(ei.value).__name__ == exc
        # object addresses (the generator's repr) differ run to run
        msgs.append(re.sub(r"0x[0-9a-f]+", "0x", str(ei.value)))
    assert msgs[0] == msgs[1]


def test_context_matches_reference():
    for n in (1, 2, 5):
        r, p = ref_gt.n_nemesis_context(n), port_gt.n_nemesis_context(n)
        assert (r.time, sorted(map(str, r.free_threads)), r.workers) == \
            (p.time, sorted(map(str, p.free_threads)), p.workers)
        assert [r.next_process(t) for t in r.all_threads()] == \
            [p.next_process(t) for t in p.all_threads()]


def test_pending_when_all_busy():
    from dataclasses import replace
    for gen, gt in PACKAGES.values():
        ctx = replace(gt.default_context(), free_threads=frozenset())
        assert gen.op({"f": "write"}, {}, ctx) == (gen.PENDING,
                                                   {"f": "write"})
