"""End-to-end parity of the PyTorch/CUDA port's linearizability check.

The port's `ops.wgl.check` on `device="cpu"` (the plain PyTorch chunk
under the host plan: 1024-round chunks, the adaptive ladder) must agree
with the JAX package's `wgl.check` on the verdict, configs explored,
rounds, final beam width K and the ladder's path, and with the host
oracle's verdict. Histories are built once with the JAX package's
types and handed to the port as op dicts; the JAX side pads every
encoding into one shared shape bucket so XLA:CPU compiles once per K
(padding changes no search counter: padded ops are never candidates).
"""

import random

import pytest
import jax
import torch

from jepsen_tpu import checker as jchecker
from jepsen_tpu import history as jh
from jepsen_tpu import synth as jsynth
from jepsen_tpu.models import core as jmodels
from jepsen_tpu.ops import adapt as jadapt
from jepsen_tpu.ops import encode as jencode
from jepsen_tpu.ops import wgl as jwgl
from jepsen_tpu_torch import checker as tchecker
from jepsen_tpu_torch import history as th
from jepsen_tpu_torch import synth as tsynth
from jepsen_tpu_torch.models import core as tmodels
from jepsen_tpu_torch.ops import adapt as tadapt
from jepsen_tpu_torch.ops import encode as tencode
from jepsen_tpu_torch.ops import wgl as twgl
from jepsen_tpu_torch.ops import wgl_ref as tref

# the parity corpora are small: intra-op threads only contend with the
# other test workers
torch.set_num_threads(1)

BUCKET = {"n_pad": 128, "ic_pad": 32, "S": 16, "O": 32}
MODELS = {"register": (jmodels.register, tmodels.register),
          "cas": (jmodels.cas_register, tmodels.cas_register),
          "mutex": (jmodels.mutex, tmodels.mutex),
          "fifo": (jmodels.fifo_queue, tmodels.fifo_queue)}


def to_port(hist):
    return th.History([th.Op.from_dict(o.to_dict()) for o in hist])


# --- corpora: the deterministic and seeded cases of test_wgl_tpu.py ------

def _deterministic():
    i, o, inf = jh.invoke, jh.ok, jh.info
    return {
        "trivial-valid": ("register", [
            i(0, "write", 1), o(0, "write", 1),
            i(0, "read", None), o(0, "read", 1)]),
        "trivial-invalid": ("register", [
            i(0, "write", 1), o(0, "write", 1),
            i(0, "read", None), o(0, "read", 2)]),
        "concurrent-reorder": ("register", [
            i(0, "write", 1), i(1, "write", 2), o(1, "write", 2),
            o(0, "write", 1), i(0, "read", None), o(0, "read", 1)]),
        "realtime-order": ("register", [
            i(0, "write", 1), o(0, "write", 1),
            i(0, "write", 2), o(0, "write", 2),
            i(0, "read", None), o(0, "read", 1)]),
        "crashed-write-takes-effect": ("register", [
            i(0, "write", 1), inf(0, "write", 1),
            i(1, "read", None), o(1, "read", 1)]),
        "crashed-write-not": ("register", [
            i(0, "write", 9), inf(0, "write", 9),
            i(1, "write", 1), o(1, "write", 1),
            i(1, "read", None), o(1, "read", 1)]),
        "cas-basic": ("cas", [
            i(0, "write", 0), o(0, "write", 0),
            i(1, "cas", [0, 3]), o(1, "cas", [0, 3]),
            i(0, "read", None), o(0, "read", 3)]),
        "cas-invalid": ("cas", [
            i(0, "write", 0), o(0, "write", 0),
            i(1, "cas", [1, 3]), o(1, "cas", [1, 3])]),
        "mutex": ("mutex", [
            i(0, "acquire", None), o(0, "acquire", None),
            i(1, "acquire", None),
            i(0, "release", None), o(0, "release", None),
            o(1, "acquire", None),
            i(1, "release", None), o(1, "release", None)]),
        "mutex-double-acquire": ("mutex", [
            i(0, "acquire", None), o(0, "acquire", None),
            i(1, "acquire", None), o(1, "acquire", None)]),
        "fifo": ("fifo", [
            i(0, "enqueue", 1), o(0, "enqueue", 1),
            i(0, "enqueue", 2), o(0, "enqueue", 2),
            i(1, "dequeue", None), o(1, "dequeue", 1),
            i(1, "dequeue", None), o(1, "dequeue", 2)]),
        "fifo-out-of-order": ("fifo", [
            i(0, "enqueue", 1), o(0, "enqueue", 1),
            i(0, "enqueue", 2), o(0, "enqueue", 2),
            i(1, "dequeue", None), o(1, "dequeue", 2)]),
    }


def gen_register_history(rng, n_procs, n_ops, values=3, crash_p=0.05):
    """A simulated concurrent run against a real register with
    occasional lies and crashes (the generator of test_wgl_tpu.py)."""
    hist = jh.History()
    reg = rng.randrange(values)
    hist.append(jh.invoke(99, "write", reg))
    hist.append(jh.ok(99, "write", reg))
    pending = {}
    free = list(range(n_procs))
    issued = 0
    while issued < n_ops or pending:
        can_invoke = free and issued < n_ops
        if not can_invoke and not pending:
            break
        if can_invoke and (not pending or rng.random() < 0.6):
            p = free.pop(rng.randrange(len(free)))
            f = rng.choice(["read", "write", "cas"])
            if f == "read":
                v = None
            elif f == "write":
                v = rng.randrange(values)
            else:
                v = [rng.randrange(values), rng.randrange(values)]
            hist.append(jh.invoke(p, f, v))
            pending[p] = (f, v)
            issued += 1
        else:
            p = rng.choice(list(pending))
            f, v = pending.pop(p)
            r = rng.random()
            if r < crash_p:
                hist.append(jh.info(p, f, v))
                if rng.random() < 0.5 and f != "read":
                    reg = v if f == "write" else (
                        v[1] if v[0] == reg else reg)
            elif r < crash_p + 0.08 and f == "cas":
                hist.append(jh.fail(p, f, v))
                free.append(p)
            else:
                if f == "read":
                    val = reg if rng.random() > 0.06 else (reg + 1) % values
                    hist.append(jh.ok(p, f, val))
                elif f == "write":
                    reg = v
                    hist.append(jh.ok(p, f, v))
                else:
                    if v[0] == reg:
                        reg = v[1]
                        hist.append(jh.ok(p, f, v))
                    else:
                        hist.append(jh.fail(p, f, v))
                free.append(p)
    return hist


def _corpus():
    out = {k: (m, jh.History(ops)) for k, (m, ops) in _deterministic().items()}
    for seed in range(12):
        out[f"random-{seed}"] = ("cas", gen_register_history(
            random.Random(1000 + seed), n_procs=4, n_ops=30))
    for seed in range(6):
        out[f"random-larger-{seed}"] = ("cas", gen_register_history(
            random.Random(7000 + seed), n_procs=5, n_ops=60, crash_p=0.03))
    return out


CORPUS = _corpus()


def _key(res):
    u = res.get("util", {})
    return {"valid?": res["valid?"],
            "configs_explored": res.get("configs_explored"),
            "rounds": u.get("rounds"), "K": res.get("K"),
            "adapt_path": u.get("adapt", {}).get("path")}


@pytest.mark.parametrize("frontier", [None, 256])
@pytest.mark.parametrize("name", list(CORPUS))
def test_check_matches_jax_and_oracle(name, frontier):
    model, hist = CORPUS[name]
    jm, tm = MODELS[model]
    want = jwgl.check(jm(), hist, frontier=frontier, shape_bucket=BUCKET)
    got = twgl.check(tm(), to_port(hist), frontier=frontier, device="cpu")
    assert _key(got) == _key(want), name
    assert got["valid?"] == tref.check(tm(), to_port(hist))["valid?"]


def test_ladder_switch_matches_jax():
    """A search that outlives two chunks climbs the ladder the same way
    in both packages: a pin set at the first poll forces a switch at
    the second, so the frontier migrates mid-search."""
    hist = jsynth.cas_register_history(2200, n_procs=5, seed=5)

    def run(pkg_check, pkg_adapt, model, h):
        def stop():
            pkg_adapt.pin_ladder(16, reason="test")
            return False
        try:
            return pkg_check(model, h, stop=stop)
        finally:
            pkg_adapt.unpin_ladder()

    want = run(jwgl.check, jadapt, jmodels.cas_register(), hist)
    got = run(lambda m, h, stop: twgl.check(m, h, stop=stop, device="cpu"),
              tadapt, tmodels.cas_register(), to_port(hist))
    assert _key(got) == _key(want)
    assert got["util"]["adapt"]["path"] == [[2, 16, "pinned"]]
    assert got["valid?"] is True and got["K"] == 16


@pytest.mark.parametrize("name", ["cas-basic", "mutex", "fifo",
                                  "random-3", "random-larger-2"])
def test_encode_matches_jax(name):
    model, hist = CORPUS[name]
    jm, tm = MODELS[model]
    want = jencode.encode(jm(), hist)
    got = tencode.encode(tm(), to_port(hist))
    for f in ("inv", "ret", "opcode", "sufminret", "inv_info",
              "opcode_info", "table"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and a.shape == b.shape, f
        assert (a == b).all(), f
    for f in ("n_ok", "n_info", "window", "window_raw"):
        assert getattr(got, f) == getattr(want, f), f


def test_synth_matches_jax():
    for n, seed, lie in ((300, 42, 0.0), (200, 7, 0.05)):
        want = jsynth.cas_register_history(n, seed=seed, lie_p=lie)
        got = tsynth.cas_register_history(n, seed=seed, lie_p=lie)
        assert [o.to_dict() for o in got] == [o.to_dict() for o in want]
    assert ([o.to_dict() for o in tsynth.mutex_history(80, seed=5)]
            == [o.to_dict() for o in jsynth.mutex_history(80, seed=5)])


@pytest.mark.parametrize("name", ["trivial-valid", "trivial-invalid",
                                  "mutex-double-acquire", "random-0",
                                  "random-larger-1"])
@pytest.mark.parametrize("algorithm", ["cuda-wgl", "wgl"])
def test_checker_verdict_matches_jax(name, algorithm):
    model, hist = CORPUS[name]
    jm, tm = MODELS[model]
    want = jchecker.linearizable(jm(), algorithm="wgl").check({}, hist, {})
    got = tchecker.linearizable(tm(), algorithm=algorithm,
                                device="cpu").check({}, to_port(hist), {})
    assert got["valid?"] == want["valid?"]
    assert got["algorithm"] == algorithm
    if got["valid?"] is False:
        assert got["final_paths"] and len(got["final_paths"]) <= 10


def test_checker_gates_malformed_history():
    hist = th.History([th.invoke(0, "write", 1), th.invoke(0, "write", 2),
                       th.ok(0, "write", 2)]).index()
    res = tchecker.linearizable(tmodels.register(), algorithm="cuda-wgl",
                                device="cpu").check({}, hist, {})
    assert res["valid?"] == "unknown"
    assert res["cause"] == "malformed-history"
    assert res["anomalies"][0]["rule"] == "H001"
    assert res["algorithm"] == "cuda-wgl"


def test_checker_strips_nemesis_and_rejects_unknown_algorithm():
    hist = th.History([th.invoke(0, "write", 1), th.ok(0, "write", 1),
                       th.info("nemesis", "start", None),
                       th.invoke(0, "read", None), th.ok(0, "read", 1)])
    res = tchecker.linearizable(tmodels.register(), algorithm="cuda-wgl",
                                device="cpu").check({}, hist.index(), {})
    assert res["valid?"] is True
    with pytest.raises(ValueError):
        tchecker.linearizable(tmodels.register(), algorithm="tpu-wgl")


def test_empty_history_is_valid():
    assert twgl.check(tmodels.register(), th.History(),
                      device="cpu")["valid?"] is True


def test_default_device_is_the_card():
    """device=None means CUDA: without a card it raises rather than
    running on the CPU; with one the verdict matches the host's."""
    model, hist = CORPUS["random-larger-0"]
    ph = to_port(hist)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            twgl.check(tmodels.cas_register(), ph)
        with pytest.raises(RuntimeError):
            tchecker.linearizable(tmodels.cas_register()).check({}, ph, {})
        return
    got = twgl.check(tmodels.cas_register(), ph)
    want = twgl.check(tmodels.cas_register(), ph, device="cpu")
    assert got["platform"] == "cuda"
    assert got["valid?"] == want["valid?"]
