"""The port's bank workload (`workloads/bank.py`), held against the JAX
package: the twins of `tests/test_workloads.py`'s bank cases (the
checker's golden maps and an end-to-end run through the interpreter with
an in-process bank), the seeded generator's first 50 ops, seeded
histories with drifting totals, unknown accounts, nil and negative
balances through both checkers (equal results, the ops compared as
data), and the plotter: `bank.png` where matplotlib is installed, and no
file, still valid, where it is not (as on the card's machine).
"""

import random
import threading

import pytest

from jepsen_tpu import generator as ref_gen
from jepsen_tpu.generator import testlib as ref_testlib
from jepsen_tpu.history import History as RefHistory
from jepsen_tpu.history import Op as RefOp
from jepsen_tpu.workloads import bank as ref_bank
from jepsen_tpu_torch import client as jclient
from jepsen_tpu_torch import core
from jepsen_tpu_torch import generator as gen
from jepsen_tpu_torch.generator import testlib
from jepsen_tpu_torch.history import History, Op
from jepsen_tpu_torch.workloads import bank


def op(typ, process, f, value, time=0, **extra):
    return Op(typ, f=f, process=process, value=value, time=time,
              extra=extra)


def hist(ops):
    return History(ops).index()


# -- the twins of tests/test_workloads.py's bank cases ---------------------

class TestBankChecker:
    TEST = {"accounts": [0, 1, 2], "total-amount": 30}

    def c(self, ops, negative=False):
        return bank.checker(negative).check(self.TEST, hist(ops), {})

    def test_valid(self):
        res = self.c([op("ok", 0, "read", {0: 10, 1: 10, 2: 10})])
        assert res["valid?"] is True
        assert res["read-count"] == 1
        assert res["error-count"] == 0

    def test_wrong_total(self):
        res = self.c([op("ok", 0, "read", {0: 10, 1: 10, 2: 11}),
                      op("ok", 0, "read", {0: 10, 1: 10, 2: 5})])
        assert res["valid?"] is False
        err = res["errors"]["wrong-total"]
        assert err["count"] == 2
        assert err["lowest"]["total"] == 25
        assert err["highest"]["total"] == 31

    def test_unexpected_key_and_nil(self):
        res = self.c([op("ok", 0, "read", {0: 10, 9: 20}),
                      op("ok", 0, "read", {0: None, 1: 20, 2: 10})])
        assert res["valid?"] is False
        assert res["errors"]["unexpected-key"]["first"]["unexpected"] == [9]
        assert res["errors"]["nil-balance"]["first"]["nils"] == {0: None}

    def test_negative_value(self):
        h = [op("ok", 0, "read", {0: -5, 1: 20, 2: 15})]
        assert self.c(h)["valid?"] is False
        assert self.c(h, negative=True)["valid?"] is True

    def test_first_error_is_earliest(self):
        res = self.c([op("ok", 0, "read", {0: 10, 1: 10, 2: 10}),
                      op("ok", 0, "read", {0: 1, 1: 1, 2: 1}),
                      op("ok", 0, "read", {0: 99, 1: 0, 2: 0})])
        assert res["first-error"]["type"] == "wrong-total"
        assert res["first-error"]["op"].index == 1


class BankClient(jclient.Client):
    """In-process bank: per-account balances under one lock."""

    def __init__(self, state=None, lock=None):
        self.state = state
        self.lock = lock or threading.Lock()

    def open(self, test, node):
        if self.state is None:
            n = len(test["accounts"])
            self.state = {a: test["total-amount"] // n
                          for a in test["accounts"]}
            self.state[test["accounts"][0]] += (
                test["total-amount"] - sum(self.state.values()))
        return BankClient(self.state, self.lock)

    def invoke(self, test, o):
        with self.lock:
            if o["f"] == "read":
                return {**o, "type": "ok", "value": dict(self.state)}
            v = o["value"]
            if self.state[v["from"]] < v["amount"]:
                return {**o, "type": "fail"}
            self.state[v["from"]] -= v["amount"]
            self.state[v["to"]] += v["amount"]
            return {**o, "type": "ok"}


def test_bank_end_to_end(tmp_path):
    w = bank.workload()
    t = {
        "name": "bank-e2e", "store_root": str(tmp_path),
        "nodes": ["n1", "n2", "n3"], "concurrency": 3,
        "ssh": {"dummy?": True},
        "client": BankClient(),
        **w,
        "generator": gen.limit(60, gen.clients(w["generator"])),
    }
    res = core.run(t)
    assert res["results"]["valid?"] is True
    assert res["results"]["SI"]["read-count"] > 0


# -- parity ------------------------------------------------------------------

def test_workload_defaults_match_reference():
    w, rw = bank.workload(), ref_bank.workload()
    assert {k: v for k, v in w.items() if k not in ("checker", "generator")} \
        == {k: v for k, v in rw.items() if k not in ("checker",
                                                     "generator")}
    assert bank.workload({"negative_balances": True})["checker"] \
        .checker_map["SI"].negative_balances is True


@pytest.mark.parametrize("seed", (0, 1, 2))
def test_generator_matches_reference(seed):
    test = bank.workload()

    def first_ops(gen_mod, testlib_mod, bank_mod):
        gen_mod.RNG.seed(seed)
        return testlib_mod.simulate(
            gen_mod.limit(50, gen_mod.clients(bank_mod.generator())),
            lambda c, inv: {**inv, "type": "ok"}, None, test)

    port = first_ops(gen, testlib, bank)
    assert port == first_ops(ref_gen, ref_testlib, ref_bank)
    assert {o["f"] for o in port} == {"read", "transfer"}


def random_reads(seed: int, n: int = 60) -> list:
    """Reads of a 5-account bank holding 100, as dicts: most conserve
    the total, some drift, name an unknown account, hold a nil or go
    negative."""
    rng = random.Random(seed)
    out = []
    for i in range(n):
        bals = [20] * 5
        for _ in range(4):
            a, b = rng.randrange(5), rng.randrange(5)
            amt = rng.randrange(1, 6)
            bals[a] -= amt
            bals[b] += amt
        value = dict(enumerate(bals))
        r = rng.random()
        if r < 0.1:
            value[rng.randrange(5)] += rng.choice([-3, 4])
        elif r < 0.15:
            value[7] = 0
        elif r < 0.2:
            value[rng.randrange(5)] = None
        elif r < 0.25:
            value[0], value[1] = -5, value[1] + value[0] + 5
        typ = "ok" if rng.random() < 0.9 else rng.choice(["fail", "info"])
        out.append(dict(type="invoke", f="read", process=i % 3,
                        value=None, time=2 * i))
        out.append(dict(type=typ, f="read", process=i % 3,
                        value=value if typ == "ok" else None,
                        time=2 * i + 1))
    return out


def as_data(x):
    """A checker result with its ops as dicts."""
    if isinstance(x, (Op, RefOp)):
        return x.to_dict()
    if isinstance(x, dict):
        return {k: as_data(v) for k, v in x.items()}
    if isinstance(x, list):
        return [as_data(v) for v in x]
    return x


@pytest.mark.parametrize("negative", (False, True))
@pytest.mark.parametrize("seed", (0, 1, 2))
def test_checker_matches_reference(seed, negative):
    test = {"accounts": list(range(5)), "total-amount": 100}
    ops = random_reads(seed)
    port = bank.checker(negative).check(
        test, History([Op.from_dict(o) for o in ops]).index(), {})
    ref = ref_bank.checker(negative).check(
        test, RefHistory([RefOp.from_dict(o) for o in ops]).index(), {})
    assert as_data(port) == as_data(ref)
    assert port["valid?"] is False and port["error-count"] > 0


def plotted(tmp_path, bank_mod, hist_cls, op_cls):
    ops = random_reads(4, 30)
    test = {"name": "bank-plot", "start_time": "20260729T000000",
            "store_root": str(tmp_path), "nodes": ["n1", "n2", "n3"],
            "concurrency": 3}
    h = hist_cls([op_cls.from_dict(o) for o in ops]).index()
    res = bank_mod.plotter().check(test, h, {})
    png = tmp_path / "bank-plot" / "20260729T000000" / "bank.png"
    return res, png.exists()


def test_plotter_writes_bank_png_as_the_reference(tmp_path):
    pytest.importorskip("matplotlib")
    port = plotted(tmp_path / "port", bank, History, Op)
    assert port == plotted(tmp_path / "ref", ref_bank, RefHistory, RefOp)
    assert port == ({"valid?": True}, True)


def test_plotter_without_matplotlib_writes_nothing(tmp_path, monkeypatch):
    monkeypatch.setattr(bank, "_plt", lambda: None)
    assert plotted(tmp_path, bank, History, Op) == ({"valid?": True}, False)
