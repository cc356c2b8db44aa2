"""The port's linearizability algorithms against the JAX package's.

`queuecheck.check` and `jitlin.check` are host copies: on the same
histories they must return the JAX package's results. The checker's
algorithms (`competition`, the default; `cuda-wgl` on `device="cpu"`;
`wgl`; `linear`; `queue-poly`) must give the JAX checker's verdicts
under the same algorithm (`cuda-wgl` against the JAX `tpu-wgl`). The
competition's two departures from the reference are pinned here: no
card raises, and a lane's exception is raised by `check`. So is its
third lane on the card, `device@cpu` (the search on the host kernel),
with a stubbed card lane: the device resolves to CUDA and `wgl.check`
answers for it.
"""

import random
import threading
import time

import pytest
import jax
import torch

from jepsen_tpu import checker as jchecker
from jepsen_tpu import history as jh
from jepsen_tpu import synth as jsynth
from jepsen_tpu.models import core as jmodels
from jepsen_tpu.ops import jitlin as jjitlin
from jepsen_tpu.ops import queuecheck as jqueue
from jepsen_tpu_torch import checker as tchecker
from jepsen_tpu_torch import history as th
from jepsen_tpu_torch.models import core as tmodels
from jepsen_tpu_torch.ops import jitlin as tjitlin
from jepsen_tpu_torch.ops import queuecheck as tqueue
from jepsen_tpu_torch.ops import wgl as twgl
from jepsen_tpu_torch.ops import wgl_ref as tref

# intra-op threads only contend with the other test workers
torch.set_num_threads(1)

MODELS = {"register": (jmodels.register, tmodels.register),
          "cas": (jmodels.cas_register, tmodels.cas_register),
          "mutex": (jmodels.mutex, tmodels.mutex),
          "fifo": (jmodels.fifo_queue, tmodels.fifo_queue)}


def to_port(hist):
    return th.History([th.Op.from_dict(o.to_dict()) for o in hist])


# --- queue-poly --------------------------------------------------------------

def _intervals(ops):
    """[(f, v, inv_t, ret_t)] -> History, each op on its own process."""
    events = []
    for p, (f, v, t0, t1) in enumerate(ops):
        events.append((t0, 0, jh.invoke(p, f, v, time=t0)))
        events.append((t1, 1, jh.ok(p, f, v, time=t1)))
    events.sort(key=lambda e: (e[0], e[1]))
    return jh.History([e[2] for e in events]).index()


def random_queue_history(rng):
    """A few values; half real queue runs (sometimes with two dequeue
    values swapped), half random intervals (often invalid)."""
    n_vals = rng.randint(1, 5)
    ops = []
    if rng.random() < 0.5:
        q, pend, t = [], [], 0
        vals = list(range(n_vals))
        while vals or q or pend:
            r = rng.random()
            if vals and r < 0.45:
                pend.append(("enqueue", vals.pop(0), t))
            elif pend and r < 0.75:
                f, v, t0 = pend.pop(rng.randrange(len(pend)))
                if f == "dequeue":
                    if not q:
                        continue
                    v = q.pop(0)
                else:
                    q.append(v)
                ops.append((f, v, t0, t))
            elif q and rng.random() < 0.8:
                pend.append(("dequeue", None, t))
            t += 1
        dqs = [i for i, o in enumerate(ops) if o[0] == "dequeue"]
        if len(dqs) >= 2 and rng.random() < 0.4:
            i, j = rng.sample(dqs, 2)
            ops[i], ops[j] = (ops[i][:1] + ops[j][1:2] + ops[i][2:],
                              ops[j][:1] + ops[i][1:2] + ops[j][2:])
    else:
        t_max = rng.randint(4, 20)
        for v in range(n_vals):
            a = rng.randint(0, t_max)
            ops.append(("enqueue", v, a, a + rng.randint(1, 6)))
            if rng.random() < 0.8:
                b = rng.randint(0, t_max)
                ops.append(("dequeue", v, b, b + rng.randint(1, 6)))
    return _intervals(ops)


def _queue_result(mod, hist):
    try:
        return mod.check(hist)
    except mod.QueueUnsupported as e:
        return ("unsupported", str(e))


@pytest.mark.parametrize("block", range(4))
def test_queuecheck_matches_jax(block):
    verdicts = set()
    for seed in range(block * 150, (block + 1) * 150):
        hist = random_queue_history(random.Random(seed))
        want = _queue_result(jqueue, hist)
        assert _queue_result(tqueue, to_port(hist)) == want, seed
        verdicts.add(want[0] if isinstance(want, tuple)
                     else want["valid?"])
    assert {True, False} <= verdicts


def test_queuecheck_big_runs_match_jax():
    hist = jsynth.fifo_queue_history(3000, n_procs=4, seed=2)
    ops = list(hist)
    dq = [i for i, o in enumerate(ops) if o.is_ok and o.f == "dequeue"]
    i, j = dq[50], dq[-50]
    ops[i], ops[j] = (ops[i].with_(value=ops[j].value),
                      ops[j].with_(value=ops[i].value))
    bad = jh.History(ops).index()
    for h, verdict in ((hist, True), (bad, False)):
        want = jqueue.check(h)
        assert want["valid?"] is verdict
        assert tqueue.check(to_port(h)) == want


def test_queuecheck_unsupported_shapes_match_jax():
    i, o, inf = jh.invoke, jh.ok, jh.info
    cases = [
        [i(0, "enqueue", 1), o(0, "enqueue", 1), i(1, "dequeue", None),
         o(1, "dequeue", None)],                          # unknown value
        [i(0, "enqueue", 1), o(0, "enqueue", 1), i(1, "enqueue", 1),
         o(1, "enqueue", 1)],                              # duplicate
        [i(0, "enqueue", 1), o(0, "enqueue", 1), i(1, "dequeue", None),
         i(2, "enqueue", 2), o(2, "enqueue", 2), i(3, "dequeue", None),
         o(3, "dequeue", 2)],                  # invalid with an open op
        [i(0, "enqueue", 1), inf(0, "enqueue", 1), i(1, "dequeue", None),
         o(1, "dequeue", 1)],                  # crashed, then dequeued
    ]
    for ops in cases:
        hist = jh.History(ops).index()
        assert _queue_result(tqueue, to_port(hist)) == _queue_result(
            jqueue, hist)


# --- linear ---------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(8))
def test_jitlin_matches_jax(seed):
    hist = jsynth.cas_register_history(40, n_procs=4, seed=seed,
                                       crash_p=0.05,
                                       lie_p=0.08 if seed % 2 else 0.0)
    want = jjitlin.check(jmodels.cas_register(), hist)
    got = tjitlin.check(tmodels.cas_register(), to_port(hist))
    assert got == want
    assert got["valid?"] == tref.check(tmodels.cas_register(),
                                       to_port(hist))["valid?"]


def test_jitlin_mutex_and_budget_match_jax():
    hist = jsynth.mutex_history(60, n_procs=3, seed=2)
    assert (tjitlin.check(tmodels.mutex(), to_port(hist))
            == jjitlin.check(jmodels.mutex(), hist))
    hist = jsynth.cas_register_history(60, n_procs=5, seed=1, crash_p=0.3)
    want = jjitlin.check(jmodels.cas_register(), hist, max_configs=50)
    got = tjitlin.check(tmodels.cas_register(), to_port(hist),
                        max_configs=50)
    assert got == want and got["valid?"] == "unknown"


# --- the checker's algorithms -------------------------------------------------

def _corpus():
    i, o = jh.invoke, jh.ok
    return {
        "register-invalid": ("register", jh.History([
            i(0, "write", 1), o(0, "write", 1),
            i(0, "read", None), o(0, "read", 2)])),
        "cas-valid": ("cas", jsynth.cas_register_history(
            60, n_procs=4, seed=3, crash_p=0.05)),
        "cas-invalid": ("cas", jsynth.cas_register_history(
            60, n_procs=4, seed=8, crash_p=0.05, lie_p=0.1)),
        "fifo-valid": ("fifo", jsynth.fifo_queue_history(40, seed=1)),
        "fifo-invalid": ("fifo", jh.History([
            i(0, "enqueue", 1), o(0, "enqueue", 1),
            i(0, "enqueue", 2), o(0, "enqueue", 2),
            i(1, "dequeue", None), o(1, "dequeue", 2)])),
    }


CORPUS = _corpus()
JAX_NAME = {"cuda-wgl": "tpu-wgl"}


@pytest.mark.parametrize("algorithm", tchecker.ALGORITHMS)
@pytest.mark.parametrize("name", list(CORPUS))
def test_checker_verdict_matches_jax(name, algorithm):
    model, hist = CORPUS[name]
    jm, tm = MODELS[model]
    want = jchecker.linearizable(
        jm(), algorithm=JAX_NAME.get(algorithm, algorithm)).check(
            {}, hist, {})
    got = tchecker.linearizable(tm(), algorithm=algorithm,
                                device="cpu").check({}, to_port(hist), {})
    assert got["valid?"] == want["valid?"], (name, got, want)
    assert got["algorithm"] == algorithm
    if algorithm == "queue-poly" and model != "fifo":
        assert got["cause"] == want["cause"]
    if algorithm == "competition" and model != "fifo":
        assert got["engine"] in ("device", "oracle")
    if model == "fifo" and algorithm in ("competition", "queue-poly"):
        assert got["engine"] == "queue-poly"


def test_default_algorithm_is_competition():
    assert tchecker.linearizable().algorithm == "competition"
    assert tchecker.Linearizable(tmodels.mutex()).algorithm == "competition"


def test_competition_decides_wide_windows_with_an_engine():
    """A wide-window history through the default checker, raced on the
    CPU and through the serial ladder (CPU with a time limit)."""
    hist = to_port(jsynth.long_tail_history(120, seed=3))
    raced = tchecker.linearizable(tmodels.cas_register(),
                                  device="cpu").check({}, hist, {})
    serial = tchecker.linearizable(tmodels.cas_register(), time_limit=60,
                                   device="cpu").check({}, hist, {})
    for res in (raced, serial):
        assert res["valid?"] is True
        assert res["engine"] in ("device", "oracle")
        assert res["algorithm"] == "competition"


def test_competition_serial_ladder_runs_the_device(monkeypatch):
    """When the oracle's first slice cannot decide, the ladder's device
    step decides and the result says so."""
    def slow_oracle(model, history, time_limit=None, stop=None, **kw):
        return {"valid?": "unknown", "cause": "timeout"}

    monkeypatch.setattr(tref, "check", slow_oracle)
    hist = to_port(CORPUS["cas-invalid"][1])
    res = tchecker.linearizable(tmodels.cas_register(), time_limit=30,
                                device="cpu").check({}, hist, {})
    assert res["valid?"] is False and res["engine"] == "device"


def test_competition_without_a_card_raises(monkeypatch):
    """device=None is the card: with none, the default checker raises
    in the caller's thread instead of letting the oracle answer."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    hist = to_port(CORPUS["cas-valid"][1])
    with pytest.raises(RuntimeError):
        tchecker.linearizable(tmodels.cas_register()).check({}, hist, {})


@pytest.mark.parametrize("lane", ["device", "oracle"])
def test_competition_raises_a_lane_exception(lane, monkeypatch):
    def boom(*a, **kw):
        raise RuntimeError(f"{lane} lane failed")

    monkeypatch.setattr(twgl if lane == "device" else tref, "check", boom)
    hist = to_port(CORPUS["cas-valid"][1])
    with pytest.raises(RuntimeError, match=f"{lane} lane failed"):
        tchecker.linearizable(tmodels.cas_register(),
                              device="cpu").check({}, hist, {})


# --- the device@cpu lane (a stubbed card lane) -------------------------------

def _stub_card(monkeypatch, card=None, host=None, oracle=None):
    """The race's device resolves to CUDA; `wgl.check` calls `card`
    for the card (default: wait for the stop, then "cancelled") and
    `host` for the CPU (default: the real search); the oracle is
    `oracle` when given. Returns {lane thread name: devices asked}."""
    real = twgl.check
    seen: dict = {}

    def wait(stop):
        while not stop():
            time.sleep(0.002)
        return {"valid?": "unknown", "cause": "cancelled"}

    def check(model, history, stop=None, device=None, **kw):
        name = threading.current_thread().name
        seen.setdefault(name, []).append(str(device))
        if torch.device(device).type == "cuda":
            return card(stop) if card else wait(stop)
        return (host or real)(model, history, stop=stop, device=device,
                              **kw)

    monkeypatch.setattr(tchecker, "resolve_device",
                        lambda device=None: torch.device("cuda"))
    monkeypatch.setattr(twgl, "check", check)
    if oracle is not None:
        monkeypatch.setattr(tref, "check", oracle)
    return seen


def test_race_on_the_card_arms_the_host_lane_that_names_itself(monkeypatch):
    """On the card the race runs three lanes; with the card lane and the
    oracle held back, the host lane decides, says so and names its
    platform."""
    def no_oracle(model, history, time_limit=None, stop=None, **kw):
        return {"valid?": "unknown", "cause": "timeout"}

    seen = _stub_card(monkeypatch, oracle=no_oracle)
    hist = to_port(CORPUS["cas-valid"][1])
    res = tchecker._race_competition(tmodels.cas_register(), hist, None)
    assert res["valid?"] is True and res["engine"] == "device@cpu"
    assert res["platform"] == "cpu"
    assert seen == {"wgl-device": ["cuda"], "wgl-device@cpu": ["cpu"]}


def test_race_of_three_unknowns_takes_the_oracles_cause(monkeypatch):
    """Every lane unknown: the cause is the oracle's, as the reference
    prefers it (oracle, device, device@cpu), and no engine is named."""
    def unknown(cause):
        return lambda *a, **kw: {"valid?": "unknown", "cause": cause}

    _stub_card(monkeypatch, card=unknown("card"), host=unknown("host"),
               oracle=unknown("oracle"))
    hist = to_port(CORPUS["cas-valid"][1])
    res = tchecker._race_competition(tmodels.cas_register(), hist, None)
    assert res == {"valid?": "unknown", "cause": "oracle"}


def test_race_raises_the_host_lanes_exception(monkeypatch):
    """The host lane's exception stops the race and is raised once the
    card lane and the oracle have ended."""
    ended = []

    def boom(*a, **kw):
        raise RuntimeError("host lane failed")

    def oracle(model, history, time_limit=None, stop=None, **kw):
        while not stop():
            time.sleep(0.002)
        ended.append("oracle")
        return {"valid?": "unknown", "cause": "cancelled"}

    _stub_card(monkeypatch, host=boom, oracle=oracle)
    hist = to_port(CORPUS["cas-valid"][1])
    with pytest.raises(RuntimeError, match="host lane failed"):
        tchecker._race_competition(tmodels.cas_register(), hist, None)
    assert ended == ["oracle"]


def test_no_host_lane_on_a_cpu_device(monkeypatch):
    """On the CPU the device lane is the host kernel already: the race
    has two lanes, as the reference's on a cpu backend."""
    real = twgl.check
    seen: list = []

    def check(model, history, device=None, **kw):
        seen.append((threading.current_thread().name, str(device)))
        return real(model, history, device=device, **kw)

    monkeypatch.setattr(twgl, "check", check)
    hist = to_port(CORPUS["cas-invalid"][1])
    res = tchecker._race_competition(tmodels.cas_register(), hist, None,
                                     device="cpu")
    assert res["valid?"] is False
    assert seen == [("wgl-device", "cpu")]


def test_queue_poly_unsupported_answers_unknown():
    i, o = th.invoke, th.ok
    hist = th.History([i(0, "enqueue", 1), o(0, "enqueue", 1),
                       i(1, "enqueue", 1), o(1, "enqueue", 1)]).index()
    res = tchecker.linearizable(tmodels.fifo_queue(), algorithm="queue-poly",
                                device="cpu").check({}, hist, {})
    assert res["valid?"] == "unknown"
    assert res["cause"].startswith("queue-poly: duplicate enqueue")
    # competition falls through to the race on the same history
    res = tchecker.linearizable(tmodels.fifo_queue(),
                                device="cpu").check({}, hist, {})
    assert res["engine"] in ("device", "oracle")
