"""The port's interpreter: the cases of `tests/test_interpreter.py` on
`jepsen_tpu_torch.generator.interpreter`, the full scheduler against
in-process clients, asserting the structural invariants of the history
(interpreter_test.clj:14-80). Histories made here are also checked by
the JAX package's host oracle, which must agree with the port's checker,
and a run under a live `fleet.RunStatus` must count every invocation,
completion and nemesis event it journals.
"""

import os
import random
import sys
import time

from jepsen_tpu import checker as ref_checker
from jepsen_tpu import history as ref_h
from jepsen_tpu.models import core as ref_models
from jepsen_tpu_torch import checker, fakes, fleet, models, util
from jepsen_tpu_torch import client as jclient
from jepsen_tpu_torch import generator as gen
from jepsen_tpu_torch.generator import interpreter
from jepsen_tpu_torch.history import History


def run_test(test):
    with util.with_relative_time():
        return interpreter.run(test)


def check_structure(history):
    """Per-process invoke/complete alternation, integer times, known
    types (interpreter_test.clj asserts these invariants)."""
    outstanding = {}
    for op in history:
        assert op["type"] in ("invoke", "ok", "fail", "info")
        assert isinstance(op["time"], int) and op["time"] >= 0
        p = op["process"]
        if op["type"] == "invoke":
            assert p not in outstanding, f"double invoke for {p}"
            outstanding[p] = op
        else:
            assert p in outstanding, f"completion without invoke for {p}"
            assert outstanding.pop(p)["f"] == op["f"]


def cas_mix():
    return gen.mix([
        gen.repeat(lambda: {"f": "read"}),
        gen.repeat(lambda: {"f": "write", "value": gen.RNG.randrange(5)}),
        gen.repeat(lambda: {"f": "cas", "value": [gen.RNG.randrange(5),
                                                  gen.RNG.randrange(5)]})])


def test_empty_generator():
    assert run_test(fakes.noop_test()) == []


def test_ok_client_history():
    reg = fakes.SharedRegister()
    t = {**fakes.noop_test(),
         "concurrency": 4,
         "client": fakes.AtomClient(reg),
         "generator": gen.limit(
             40, gen.clients(gen.mix(
                 [gen.repeat({"f": "read"}),
                  gen.repeat({"f": "write", "value": 1}),
                  gen.repeat({"f": "cas", "value": [1, 2]})])))}
    h = run_test(t)
    invokes = [o for o in h if o["type"] == "invoke"]
    assert len(invokes) == 40
    assert len(h) == 80  # every op completes
    check_structure(h)
    times = [o["time"] for o in h]
    assert times == sorted(times)


def test_crashing_client_rotates_processes():
    class Crashy(jclient.Client):
        def open(self, test, node):
            return self

        def invoke(self, test, op):
            raise RuntimeError("boom")

    t = {**fakes.noop_test(),
         "concurrency": 2,
         "client": Crashy(),
         "generator": gen.limit(6, gen.clients(gen.repeat({"f": "read"})))}
    h = run_test(t)
    infos = [o for o in h if o["type"] == "info"]
    assert len(infos) == 6
    assert all("indeterminate" in o["error"] for o in infos)
    assert all("RuntimeError: boom" in o["exception"] for o in infos)
    assert len({o["process"] for o in h}) == 6
    check_structure(h)


def test_mixed_ok_fail_info():
    rng = random.Random(0)

    class Rand(jclient.Client):
        def open(self, test, node):
            return self

        def invoke(self, test, op):
            r = rng.random()
            if r < 0.2:
                raise RuntimeError("crash")
            if r < 0.4:
                return {**op, "type": "fail"}
            return {**op, "type": "ok"}

    t = {**fakes.noop_test(),
         "concurrency": 3,
         "client": Rand(),
         "generator": gen.limit(30, gen.clients(gen.repeat({"f": "w"})))}
    h = run_test(t)
    assert {o["type"] for o in h} == {"invoke", "ok", "fail", "info"}
    check_structure(h)


def test_nemesis_ops_routed():
    seen = []

    class Nem(fakes.NoopNemesis):
        def invoke(self, test, op):
            seen.append(op["f"])
            return {**op, "type": "info"}

    t = {**fakes.noop_test(),
         "concurrency": 2,
         "nemesis": Nem(),
         "generator": gen.phases(
             gen.limit(4, gen.clients(gen.repeat({"f": "read"}),
                                      gen.repeat({"f": "split",
                                                  "type": "info"}))))}
    h = run_test(t)
    assert "split" in seen
    assert all(o["f"] == "split" for o in h if o["process"] == "nemesis")


def test_invalid_completion_is_an_info():
    """A client completing with the wrong process is caught by
    `client.Validate` and journalled as a crash."""
    class Bad(jclient.Client):
        def invoke(self, test, op):
            return {**op, "type": "ok", "process": -1}

    t = {**fakes.noop_test(), "concurrency": 1, "client": Bad(),
         "generator": gen.limit(2, gen.clients(gen.repeat({"f": "r"})))}
    h = run_test(t)
    infos = [o for o in h if o["type"] == "info"]
    assert len(infos) == 2
    assert all("InvalidCompletion" in o["exception"] for o in infos)


def test_full_cas_register_pipeline_matches_reference_oracle():
    """generator -> interpreter -> history -> the port's checker, on the
    CPU: an in-process register is linearizable, and the JAX package's
    host oracle says so of the same history."""
    t = {**fakes.noop_test(),
         "concurrency": 5,
         "client": fakes.AtomClient(fakes.SharedRegister()),
         "generator": gen.limit(60, gen.clients(cas_mix()))}
    h = run_test(t)
    res = checker.linearizable(models.cas_register(), algorithm="cuda-wgl",
                               device="cpu").check(t, History(h).index(),
                                                   {})
    want = ref_checker.linearizable(ref_models.cas_register(),
                                    algorithm="wgl").check(
        {}, ref_h.History(h).index(), {})
    assert res["valid?"] is want["valid?"] is True, res


def test_sleep_and_log_not_in_history():
    t = {**fakes.noop_test(),
         "concurrency": 1,
         "generator": [gen.clients(gen.sleep(0.01)),
                       gen.clients(gen.log("hi")),
                       gen.clients({"f": "read"})]}
    h = run_test(t)
    assert {o["type"] for o in h} == {"invoke", "ok"}
    assert all(o["f"] == "read" for o in h)


def test_stagger_rate_roughly_matches():
    t = {**fakes.noop_test(),
         "concurrency": 5,
         "generator": gen.time_limit(0.4, gen.stagger(
             0.01, gen.clients(gen.repeat({"f": "read"}))))}
    start = time.monotonic()
    h = run_test(t)
    wall = time.monotonic() - start
    invokes = [o for o in h if o["type"] == "invoke"]
    # ~40 ops expected at 100 ops/s over 0.4 s; allow broad slack
    assert 10 <= len(invokes) <= 120
    assert wall < 5


def test_run_status_counts_ops_and_nemesis_window():
    """The interpreter feeds the ambient RunStatus: one op event per
    journalled invocation and completion, the nemesis window from the
    nemesis's ops (`fleet.nemesis_opens_window`)."""
    class Nem(fakes.NoopNemesis):
        def invoke(self, test, op):
            return {**op, "type": "info"}

    t = {**fakes.noop_test(), "concurrency": 2,
         "client": fakes.AtomClient(fakes.SharedRegister()),
         "nemesis": Nem(),
         "generator": [gen.clients(gen.limit(6, cas_mix())),
                       gen.nemesis({"f": "start-partition"}),
                       gen.clients(gen.limit(4, cas_mix())),
                       gen.nemesis({"f": "stop-partition"})]}
    st = fleet.RunStatus(test="interp", progress=False)
    with fleet.use(st):
        h = run_test(t)
    snap = st.snapshot()
    inv = sum(o["type"] == "invoke" for o in h)
    assert snap["ops"] == {"invoked": inv, "completed": len(h) - inv}
    assert inv == 12
    assert snap["nemesis"]["active"] is False
    assert snap["nemesis"]["f"] == "stop-partition"


def test_status_counts_survive_many_workers():
    """More workers than cores and a short switch interval: every op
    event the workers' completions feed the shared status lands (a lost
    update would leave the counts short of the history's)."""
    n = 4 * (os.cpu_count() or 2)
    t = {**fakes.noop_test(), "concurrency": n,
         "client": fakes.AtomClient(fakes.SharedRegister()),
         "generator": gen.limit(20 * n, gen.clients(cas_mix()))}
    st = fleet.RunStatus(test="stress", progress=False)
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        t0 = time.monotonic()
        with fleet.use(st):
            h = run_test(t)
        assert time.monotonic() - t0 < 30
    finally:
        sys.setswitchinterval(prev)
    check_structure(h)
    inv = sum(o["type"] == "invoke" for o in h)
    assert inv == 20 * n and len(h) == 2 * inv
    assert st.snapshot()["ops"] == {"invoked": inv, "completed": inv}
