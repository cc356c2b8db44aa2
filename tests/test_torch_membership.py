"""The port's membership nemesis (`nemesis/membership.py`), held against
the JAX package: the twins of `tests/test_membership.py` (a fake
clustered State driven through grow/shrink, view refresh and merge,
pending-op resolution, and the generator's keep-alive PENDING), and one
scenario run through both packages whose `State` views (`node_views`,
`view`, `pending`) and emitted ops must equal the reference's after
every step.
"""

import jepsen_tpu.control.dummy as ref_dummy
import jepsen_tpu.generator as ref_gen
from jepsen_tpu.nemesis import membership as ref_membership
from jepsen_tpu_torch import generator as gen
from jepsen_tpu_torch.control import dummy
from jepsen_tpu_torch.nemesis import membership

NODES = ["n1", "n2", "n3"]


def fake_state(mod):
    """An in-memory 'cluster' State of `mod`'s protocol: every node sees
    the shared membership set; ops grow/shrink it; an op resolves once
    the merged view reflects it."""
    class FakeClusterState(mod.State):
        def __init__(self, actual, plan):
            self.actual = actual          # the cluster's real member set
            self.plan = list(plan)        # ops still to issue
            self.node_views = {}
            self.view = None
            self.pending = frozenset()

        def node_view(self, test, node):
            return sorted(self.actual)

        def merge_views(self, test):
            merged = set()
            for v in self.node_views.values():
                merged.update(v)
            return sorted(merged) if merged else None

        def fs(self):
            return {"grow", "shrink"}

        def op(self, test):
            if self.pending:
                return "pending"          # wait for resolution first
            if not self.plan:
                return None
            return dict(self.plan[0])

        def invoke(self, test, op):
            self.plan = self.plan[1:]
            if op["f"] == "grow":
                self.actual.add(op["value"])
            else:
                self.actual.discard(op["value"])
            return {k: v for k, v in op.items() if k != "process"}

        def resolve_op(self, test, pair):
            # resolved once the merged view has caught up with reality
            if self.view == sorted(self.actual):
                return self
            return None

    return FakeClusterState


FakeClusterState = fake_state(membership)


def make_test(nodes, dummy_mod=dummy):
    r = dummy_mod.remote()
    return {"nodes": list(nodes), "concurrency": 2,
            "sessions": {n: r.connect({"host": n}) for n in nodes}}


def drive(nem, test, ctx):
    """One generator poll through the DSL dispatch."""
    return gen.op(nem.generator(), test, ctx)


# -- the twins of tests/test_membership.py ---------------------------------

def test_grow_shrink_scenario():
    test = make_test(NODES)
    actual = set(NODES)
    state = FakeClusterState(actual, [{"f": "grow", "value": "n4"},
                                      {"f": "shrink", "value": "n1"}])
    nem = membership.nemesis(state)
    nem.setup(test)
    try:
        ctx = gen.context(test)
        # 1: the generator proposes the first planned op, filled in
        o, g2 = drive(nem, test, ctx)
        assert o["f"] == "grow" and o["value"] == "n4"
        assert o["type"] == "invoke" and "process" in o

        res = nem.invoke(test, o)
        assert res["type"] == "info"
        assert "n4" in actual
        assert nem.state.pending  # awaiting view resolution

        # 2: while pending, the generator stays alive and PENDING
        o2, g3 = gen.op(g2, test, ctx)
        assert o2 is gen.PENDING
        assert g3 is not None

        # 3: a view refresh resolves the pending op; next op flows
        nem._refresh(test)
        assert not nem.state.pending
        assert nem.state.view == sorted(actual)
        o4, _ = gen.op(g3, test, ctx)
        assert o4["f"] == "shrink" and o4["value"] == "n1"
        nem.invoke(test, o4)
        assert "n1" not in actual
        nem._refresh(test)

        # 4: plan exhausted -> generator finally ends
        assert gen.op(nem.generator(), test, ctx) is None
    finally:
        nem.teardown(test)


def test_generator_pending_not_exhausted():
    """A pending state must NOT exhaust the generator: it must emit
    PENDING and keep itself alive."""
    test = make_test(NODES)
    state = FakeClusterState(set(NODES), [{"f": "grow", "value": "n4"}])
    state.pending = frozenset({(("f", "x"),)})  # force pending
    nem = membership.nemesis(state)
    ctx = gen.context(test)
    res = drive(nem, test, ctx)
    assert res is not None
    o, g2 = res
    assert o is gen.PENDING
    # still alive: once unblocked the op appears
    state.pending = frozenset()
    o2, _ = gen.op(g2, test, ctx)
    assert o2["f"] == "grow"


def test_fs_and_view_merge():
    test = make_test(NODES)
    state = FakeClusterState(set(NODES), [])
    nem = membership.nemesis(state)
    nem.setup(test)
    try:
        assert nem.fs() == {"grow", "shrink"}
        assert nem.state.view == sorted(NODES)
        assert set(nem.state.node_views) == set(NODES)
    finally:
        nem.teardown(test)


# -- parity -----------------------------------------------------------------

PLAN = [{"f": "grow", "value": "n4"}, {"f": "shrink", "value": "n1"},
        {"f": "grow", "value": "n5"}, {"f": "shrink", "value": "n3"}]


def scenario(mod, gen_mod, dummy_mod) -> list:
    """Every step of a grow/shrink plan through `mod`'s nemesis, each
    refresh left to resolve or not: the State's views and each step's
    op, as plain data. The generator's RNG (which picks each op's free
    process) is seeded."""
    gen_mod.RNG.seed(7)
    test = make_test(NODES, dummy_mod)
    state = fake_state(mod)(set(NODES), PLAN)
    nem = mod.nemesis(state)
    steps = []

    def views(what, out=None):
        s = nem.state
        steps.append((what, dict(sorted(s.node_views.items())), s.view,
                      sorted(s.pending), out))

    nem.setup(test)
    try:
        views("setup")
        ctx = gen_mod.context(test)
        g = nem.generator()
        for i in range(2 * len(PLAN) + 1):
            res = gen_mod.op(g, test, ctx)
            if res is None:
                views("exhausted")
                break
            o, g = res
            if o is gen_mod.PENDING:
                views("pending")
                nem._refresh(test)
                views("refresh")
                continue
            done = nem.invoke(test, o)
            views("invoke", {k: done[k] for k in ("type", "f", "value")})
    finally:
        nem.teardown(test)
    views("teardown", sorted(nem.fs()))
    return steps


def test_state_views_match_reference():
    port = scenario(membership, gen, dummy)
    assert port == scenario(ref_membership, ref_gen, ref_dummy)
    assert port[-2][0] == "exhausted"
    assert port[-1][2] == ["n2", "n4", "n5"]
