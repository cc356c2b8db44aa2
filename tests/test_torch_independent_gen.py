"""The port's independent generators against the JAX package's.

`tuple_gen`, `sequential_generator` and `concurrent_generator` (the
cases of `tests/test_independent_gen.py`, and a few more shapes) are
built once per package from its own `independent` and `generator`
modules and simulated by its own `generator.testlib` under its own
`RAND_SEED`: the op lists must be equal, tuple values included. Then
the end-to-end flow on the port: a multi-key workload made by the
port's `concurrent_generator`, run by its interpreter against
`fakes.IndependentAtomClient`, checked by the port's
`independent.cuda_checker(device="cpu")`, whose verdict and failing keys
must equal the JAX package's host oracle's on the same history.
"""

import itertools

import pytest

import jepsen_tpu.generator as ref_gen
import jepsen_tpu.generator.testlib as ref_gt
import jepsen_tpu.independent as ref_ind
from jepsen_tpu import checker as ref_checker
from jepsen_tpu import history as ref_h
from jepsen_tpu.models import core as ref_models
import jepsen_tpu_torch.generator as port_gen
import jepsen_tpu_torch.generator.testlib as port_gt
import jepsen_tpu_torch.independent as port_ind
from jepsen_tpu_torch import fakes, util
from jepsen_tpu_torch.generator import interpreter
from jepsen_tpu_torch.history import History
from jepsen_tpu_torch.models import core as port_models

PACKAGES = {"ref": (ref_gen, ref_gt, ref_ind),
            "port": (port_gen, port_gt, port_ind)}


def _norm(x):
    if hasattr(x, "k") and hasattr(x, "v"):
        return ("KV", _norm(x.k), _norm(x.v))
    if isinstance(x, dict):
        return {k: _norm(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_norm(v) for v in x]
    return x


def _writes(gen, n):
    return lambda k: gen.limit(n, gen.repeat({"f": "write", "value": k}))


def _mixed(gen, n):
    """A per-key cas-register mix drawn from the generator's own RNG."""
    return lambda k: gen.limit(n, gen.mix([
        gen.repeat(lambda: {"f": "read"}),
        gen.repeat(lambda: {"f": "write", "value": gen.RNG.randrange(5)}),
        gen.repeat(lambda: {"f": "cas", "value": [gen.RNG.randrange(5),
                                                  gen.RNG.randrange(5)]})]))


# (case id, runner, builder(gen, ind) -> generator, context size)
CASES = [
    ("sequential", "quick_ops",
     lambda g, i: i.sequential_generator([10, 20], _writes(g, 2)), None),
    ("tuple-gen", "perfect",
     lambda g, i: i.tuple_gen("k", g.limit(4, g.repeat({"f": "read"}))),
     None),
    ("concurrent-covers-keys", "perfect",
     lambda g, i: i.concurrent_generator(2, list(range(6)), _writes(g, 4)),
     4),
    ("concurrent-disjoint-groups", "perfect",
     lambda g, i: i.concurrent_generator(2, list(range(4)), _writes(g, 6)),
     4),
    ("concurrent-two-keys", "perfect",
     lambda g, i: i.concurrent_generator(2, [0, 1], _writes(g, 3)), 2),
    ("concurrent-one-op", "perfect",
     lambda g, i: i.concurrent_generator(1, [0], _writes(g, 1)), 2),
    ("concurrent-mixed-imperfect", "imperfect",
     lambda g, i: i.concurrent_generator(2, range(5), _mixed(g, 8)), 6),
    ("concurrent-infinite-keys", "perfect",
     lambda g, i: g.time_limit(3e-7, i.concurrent_generator(
         2, itertools.count(), _mixed(g, 5))), 4),
    ("concurrent-staggered", "perfect",
     lambda g, i: i.concurrent_generator(2, range(10), lambda k: g.stagger(
         1e-8, _mixed(g, 6)(k))), 10),
    ("concurrent-info", "perfect_info",
     lambda g, i: i.concurrent_generator(3, range(4), _writes(g, 3)), 6),
]


def _run(pkg, runner, build, n):
    gen, gt, ind = PACKAGES[pkg]
    ctx = gt.n_nemesis_context(n) if n is not None else None
    return getattr(gt, runner)(build(gen, ind), ctx)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_simulation_matches_reference(case):
    _, runner, build, n = case
    want = _norm(_run("ref", runner, build, n))
    got = _norm(_run("port", runner, build, n))
    assert want and got == want


def test_concurrent_generator_groups_keys():
    """The reference test's invariants, on the port: every key gets its
    ops, one group of n threads per key."""
    h = _run("port", "perfect", CASES[3][2], 4)
    key_threads: dict = {}
    for o in h:
        key_threads.setdefault(o["value"].k, set()).add(o["process"])
    assert sorted(key_threads) == [0, 1, 2, 3]
    assert all(len(ts) <= 2 for ts in key_threads.values())
    assert all(port_ind.is_tuple(o["value"]) for o in h)


@pytest.mark.parametrize("n,threads", [(2, 4), (2, 5), (9, 5), (3, 6)])
def test_group_threads_matches_reference(n, threads):
    out = []
    for gen, _, ind in PACKAGES.values():
        ctx = gen.Context(time=0, free_threads=frozenset(range(threads)),
                          workers={t: t for t in range(threads)})
        try:
            out.append(("ok", [sorted(g) for g in ind.group_threads(n,
                                                                     ctx)]))
        except AssertionError as e:
            out.append(("assert", str(e)))
    assert out[0] == out[1]


def ref_history(ops):
    """A port interpreter's op dicts as the JAX package's indexed
    History (tuple values as its own `KV`)."""
    def conv(v):
        if port_ind.is_tuple(v):
            return ref_ind.tuple_(v.k, conv(v.v))
        return v
    return ref_h.History([{**o, "value": conv(o.get("value"))}
                          for o in ops]).index()


def _run_multikey(lie_keys=(), n_keys=6, ops_per_key=12, seed=3):
    t = {**fakes.noop_test(), "concurrency": 4,
         "client": fakes.IndependentAtomClient(lie_keys=lie_keys),
         "generator": port_ind.concurrent_generator(
             2, list(range(n_keys)), _mixed(port_gen, ops_per_key))}
    with port_gen.with_seed(seed), util.with_relative_time():
        return interpreter.run(t)


@pytest.mark.parametrize("lie_keys", [(), (3,)], ids=["valid", "lying-key"])
def test_end_to_end_multikey_matches_reference_oracle(lie_keys):
    ops = _run_multikey(lie_keys)
    h = History(ops).index()
    assert sorted(port_ind.history_keys(h)) == list(range(6))
    got = port_ind.cuda_checker(port_models.cas_register(),
                                device="cpu").check({}, h, {})
    want = ref_ind.checker(ref_checker.linearizable(
        ref_models.cas_register(), algorithm="wgl")).check(
            {}, ref_history(ops), {})
    assert got["valid?"] == want["valid?"]
    assert sorted(got["failures"]) == sorted(want["failures"])
    assert set(got["failures"]) <= set(lie_keys)
    for k, r in want["results"].items():
        assert got["results"][k]["valid?"] == r["valid?"], k
    # a lying key fails on both exactly when one of its reads completed
    read = {o["value"].k for o in ops
            if o["f"] == "read" and o["type"] == "ok"}
    assert got["failures"] == sorted(set(lie_keys) & read)
