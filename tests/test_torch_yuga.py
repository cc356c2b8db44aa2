"""The port's yuga suite (`jepsen_tpu_torch/dbs/yuga.py`), on the port's
redis and sqlite, held against the JAX package: the twins of
`tests/test_yuga.py` (the namespaced dual-API registry, the test-all sweep,
live runs of both surfaces under the kill/restart nemesis), and parity
cases: the RESP commands and SQL each client sends and what it makes of
the replies, the generated ops of every workload, the multi-register
encoding of a multi-key-acid key (table, states, alphabet, window), and one
live ycql multi-key-acid history judged key by key by both packages' `wgl`
oracles.

Also: the port's ports and store root are its own (both surfaces apart
from the port's redis and sqlite tests), the `device` option reaches the
checks of `DEVICE_WORKLOADS`, and a missing card raises before any node is
set up. The suite checks on the CPU (`device="cpu"`).
"""

import json
import os

import numpy as np
import pytest
import torch

from jepsen_tpu import checker as ref_checker
from jepsen_tpu import generator as ref_gen
from jepsen_tpu import independent as ref_independent
from jepsen_tpu.dbs import yuga as ref_yuga
from jepsen_tpu.generator import testlib as ref_testlib
from jepsen_tpu.models import multi_register as ref_multi_register
from jepsen_tpu.ops import encode as ref_encode
from jepsen_tpu_torch import checker, core, independent, store
from jepsen_tpu_torch import generator as gen
from jepsen_tpu_torch.dbs import redis, sqlite, yuga
from jepsen_tpu_torch.generator import testlib
from jepsen_tpu_torch.history import History
from jepsen_tpu_torch.independent import tuple_
from jepsen_tpu_torch.models import multi_register
from jepsen_tpu_torch.ops import encode
from test_torch_etcd import kv_of, ref_kv_history
from test_torch_galera import workload_ops
from test_torch_sqlite import ephemeral_range
from test_torch_wgl32 import multi_key_acid_history


def _options(tmp_path, which, **kw):
    return {"nodes": kw.pop("nodes", ["y1"]),
            "concurrency": kw.pop("concurrency", 4),
            "time_limit": kw.pop("time_limit", 6),
            "nemesis_interval": kw.pop("nemesis_interval", 2.0),
            "workload": which,
            "store_root": str(tmp_path / "store"),
            "sandbox": str(tmp_path / "cluster"), "device": "cpu", **kw}


def test_registry_is_dual_api():
    apis = {w.split("/", 1)[0] for w in yuga.WORKLOADS}
    assert apis == {"ycql", "ysql"}
    # the shared-workload promise: both APIs expose set + counter +
    # single-key-acid built from the same workload fns
    for shared in ("set", "counter", "single-key-acid"):
        assert f"ycql/{shared}" in yuga.WORKLOADS
        assert f"ysql/{shared}" in yuga.WORKLOADS


def test_unknown_workload_rejected(tmp_path):
    with pytest.raises(ValueError, match="unknown workload"):
        yuga.yuga_test(_options(tmp_path, "ycql/nope"))


def test_tests_fn_sweeps_expected(tmp_path):
    names = [t["name"] for t in yuga.yuga_tests(_options(tmp_path, None))]
    assert len(names) == len(yuga.EXPECTED_TO_PASS)
    assert any("ycql" in n for n in names)
    assert any("ysql" in n for n in names)


@pytest.mark.parametrize("which", ["ycql/set", "ycql/counter"])
@pytest.mark.slow  # the reference twin's mark (tests/test_yuga.py)
def test_ycql_live(tmp_path, which):
    # generous time_limit: a loaded machine restarts the killed server
    # slowly, and the final read must land after recovery
    done = core.run(yuga.yuga_test(_options(tmp_path, which,
                                            time_limit=8)))
    res = done["results"]
    assert res["valid?"] is True, res


@pytest.mark.parametrize("which", ["ysql/set", "ysql/counter",
                                   "ysql/append"])
@pytest.mark.slow  # the reference twin's mark (tests/test_yuga.py)
def test_ysql_live(tmp_path, which):
    done = core.run(yuga.yuga_test(_options(tmp_path, which)))
    res = done["results"]
    assert res["valid?"] is True, res


def test_ysql_single_key_acid_live(tmp_path):
    done = core.run(yuga.yuga_test(_options(
        tmp_path, "ysql/single-key-acid", nodes=["y1"],
        concurrency=4, time_limit=5, per_key_limit=40)))
    res = done["results"]
    assert res["valid?"] is True, res


def test_ysql_long_fork_live(tmp_path):
    done = core.run(yuga.yuga_test(_options(
        tmp_path, "ysql/long-fork", time_limit=5)))
    res = done["results"]
    assert res["valid?"] is True, res


@pytest.mark.parametrize("which", ["ycql/multi-key-acid",
                                   "ysql/multi-key-acid"])
@pytest.mark.slow  # the reference twin's mark (tests/test_yuga.py)
def test_multi_key_acid_live(tmp_path, which):
    """Txn batches over 3-subkey groups checked linearizable against the
    multi-register model, on both API surfaces."""
    done = core.run(yuga.yuga_test(_options(tmp_path, which)))
    res = done["results"]
    assert res["valid?"] is True, res


def test_ycql_bank_live(tmp_path):
    """ycql/bank: conserved totals via whole-map CAS transfers."""
    done = core.run(yuga.yuga_test(_options(tmp_path, "ycql/bank")))
    res = done["results"]
    assert res["valid?"] is True, res


def test_ycql_long_fork_live(tmp_path):
    """ycql/long-fork: MGET snapshots must never expose the G2
    divergence."""
    done = core.run(yuga.yuga_test(_options(tmp_path, "ycql/long-fork")))
    res = done["results"]
    assert res["valid?"] is True, res


# -- parity with the reference ------------------------------------------------

class RecConn:
    """A connection that records each command and answers it as the mini
    servers would, from an in-memory store: GET / SET / the CAS script /
    MSET / MGET (ycql), TXN / INCRKV / CASKV / BANKINIT / BANKREAD / XFER
    (ysql). With `fail`, every command raises it."""

    def __init__(self, fail=None):
        self.fail, self.kv, self.sent = fail, {}, []

    def cmd(self, *args):
        self.sent.append(tuple(str(a) for a in args))
        if self.fail is not None:
            raise self.fail
        op, a = args[0], args[1:]
        if op == "GET":
            return self.kv.get(a[0])
        if op == "SET":
            self.kv[a[0]] = a[1]
            return "OK"
        if op == "EVAL":
            key, old, new = a[2], a[3], a[4]
            if self.kv.get(key) != old:
                return 0
            self.kv[key] = new
            return 1
        if op == "MSET":
            self.kv.update(zip(a[::2], a[1::2]))
            return "OK"
        if op == "MGET":
            return [self.kv.get(k) for k in a]
        if op == "TXN":
            out = []
            for f, k, v in json.loads(a[0]):
                if f == "r":
                    v = self.kv.get(k)
                elif f == "append":
                    self.kv[k] = self.kv.get(k, []) + [v]
                else:
                    self.kv[k] = v
                out.append([f, k, v])
            return json.dumps(out)
        if op == "INCRKV":
            self.kv[a[0]] = self.kv.get(a[0], 0) + int(a[1])
            return self.kv[a[0]]
        if op == "CASKV":
            if json.dumps(self.kv.get(a[0])) != a[1]:
                return 0
            self.kv[a[0]] = json.loads(a[2])
            return 1
        if op == "BANKINIT":
            self.kv.setdefault("bank", json.loads(a[0]))
            return "OK"
        if op == "BANKREAD":
            return json.dumps(self.kv["bank"])
        if op == "XFER":
            bank, amt = self.kv["bank"], int(a[2])
            if bank[a[0]] < amt:
                return 0
            bank[a[0]] -= amt
            bank[a[1]] += amt
            return 1
        raise AssertionError(f"unscripted command {args}")

    def close(self):
        pass


BANK_TEST = {"nodes": ["y1"], "accounts": [0, 1, 2], "total-amount": 30}
# (client, whether it seeds its key in `setup`, its ops: (f, value), a
# ("kv", k, v) value made each package's `[k v]` tuple)
SESSIONS = {
    "YcqlSetClient": (True, [("add", 3), ("add", 4), ("read", None)]),
    "YcqlCounterClient": (True, [("add", 2), ("add", 3), ("read", None)]),
    "YcqlBankClient": (True, [("read", None),
                              ("transfer", {"from": 0, "to": 1,
                                            "amount": 5}),
                              ("transfer", {"from": 2, "to": 0,
                                            "amount": 1000}),
                              ("read", None)]),
    "YcqlTxnClient": (False, [("txn", [["w", 1, 3], ["w", 2, 4]]),
                              ("txn", [["r", 1, None], ["r", 2, None],
                                       ["r", 3, None]])]),
    "YcqlMultiKeyClient": (False, [
        ("txn", ("kv", 7, [["w", 0, 1], ["w", 2, 3]])),
        ("txn", ("kv", 7, [["r", 0, None], ["r", 1, None]])),
        ("txn", ("kv", 8, [["r", 0, None]]))]),
    "YsqlSetClient": (False, [("add", 3), ("add", 4), ("read", None)]),
    "YsqlCounterClient": (False, [("add", 2), ("add", 3), ("read", None)]),
    "YsqlRegisterClient": (False, [
        ("read", ("kv", 1, None)), ("write", ("kv", 1, 3)),
        ("cas", ("kv", 1, [3, 4])), ("cas", ("kv", 1, [3, 5])),
        ("read", ("kv", 1, None))]),
    "YsqlTxnClient": (False, [("txn", [["append", 1, 3], ["r", 1, None]]),
                              ("txn", [["r", 1, None], ["r", 2, None]])]),
    "YsqlMultiKeyClient": (False, [
        ("txn", ("kv", 7, [["w", 0, 1]])),
        ("txn", ("kv", 7, [["r", 0, None], ["r", 2, None]]))]),
    "bank": (True, [("read", None),
                    ("transfer", {"from": 0, "to": 1, "amount": 5}),
                    ("transfer", {"from": 2, "to": 0, "amount": 1000})]),
}


def plain_value(v):
    """A completion's value with each package's `[k v]` tuple as ("kv", k,
    v)."""
    return ("kv", v.k, v.v) if hasattr(v, "k") else v


def client_session(mod, name: str, fail=None) -> tuple:
    """The commands the client `name` of `mod` sends over one recording
    connection (its `setup` first where it seeds a key) and its
    completions; with `fail`, every command raises it and `setup` is
    skipped. "bank" is the ysql registry's bank client."""
    if name == "bank":
        cls = type(mod.WORKLOADS["ysql/bank"]({**BANK_TEST,
                                               "concurrency": 1})["client"])
    else:
        cls = getattr(mod, name)
    seeds, ops = SESSIONS[name]
    conn = RecConn(fail)
    cl = cls().open(BANK_TEST, "y1")
    cl.conn = conn
    if seeds and fail is None:
        cl.setup(BANK_TEST)
    out = []
    for f, v in ops:
        if isinstance(v, tuple):
            v = (tuple_ if mod is yuga else ref_independent.tuple_)(v[1],
                                                                     v[2])
        cl.conn = conn
        done = cl.invoke(BANK_TEST, {"type": "invoke", "f": f, "value": v,
                                     "process": 0})
        out.append((done["type"], plain_value(done.get("value")),
                    done.get("error")))
    return conn.sent, out


@pytest.mark.parametrize("name", sorted(SESSIONS))
def test_client_commands_match_reference(name):
    got = client_session(yuga, name)
    assert got == client_session(ref_yuga, name)
    assert got[0] and all(t == "ok" for t, _, _ in got[1][:2])


@pytest.mark.parametrize("exc", ["RedisError", "ConnectionResetError"])
@pytest.mark.parametrize("name", sorted(SESSIONS))
def test_client_errors_match_reference(name, exc):
    """Every command raising: each op's fail / info split and error."""
    def fail(mod):
        return mod.RedisError("ERR x") if exc == "RedisError" else \
            ConnectionResetError("reset")
    got = client_session(yuga, name, fail(yuga))
    assert got == client_session(ref_yuga, name, fail(ref_yuga))
    assert all(t in ("fail", "info") for t, _, _ in got[1])


@pytest.mark.parametrize("which", sorted(yuga.WORKLOADS))
def test_generated_ops_match_reference(which):
    got = workload_ops(yuga, gen, testlib, which)
    assert got == workload_ops(ref_yuga, ref_gen, ref_testlib, which)
    assert len(got) == 40


def test_registry_matches_reference():
    assert sorted(yuga.WORKLOADS) == sorted(ref_yuga.WORKLOADS)
    assert yuga.EXPECTED_TO_PASS == ref_yuga.EXPECTED_TO_PASS
    assert (yuga.SET_KEY, yuga.COUNTER_KEY) == (ref_yuga.SET_KEY,
                                                ref_yuga.COUNTER_KEY)
    assert set(yuga.DEVICE_WORKLOADS) < set(yuga.WORKLOADS)


def encoding_of(enc) -> dict:
    """An encoding's search inputs, its states as their reprs (a
    multi-register's its sub-register tuple) and its alphabet as (f,
    value) by code."""
    alphabet = {}
    for o, code in zip(enc.lin_ops,
                       list(enc.opcode[:enc.n_ok])
                       + list(enc.opcode_info[:enc.n_info])):
        alphabet.setdefault(int(code), (o.f, repr(o.value)))
    return {"table": enc.table.tolist(),
            "states": [repr(s) for s in enc.states],
            "alphabet": [alphabet[c] for c in sorted(alphabet)],
            "window": (enc.window, enc.window_raw),
            "n": (enc.n_ok, enc.n_info),
            "arrays": [np.asarray(a).tolist() for a in (
                enc.inv, enc.ret, enc.opcode, enc.sufminret, enc.inv_info,
                enc.opcode_info)]}


def assert_same_encoding(hist, ref_hist):
    got = encoding_of(encode.encode(multi_register(), hist))
    want = encoding_of(ref_encode.encode(ref_multi_register(), ref_hist))
    assert got == want
    return got


def test_multi_register_encoding_matches_reference():
    """A multi-key-acid key's subhistory (two processes, the workload's
    micro-op txns, crashes) encoded by both packages with the multi-register
    model: the same table, states, alphabet and window."""
    for seed, procs in ((0, 4), (3, 2)):
        ref_hist = multi_key_acid_history(n_procs=procs, seed=seed)
        hist = History([o.to_dict() for o in ref_hist]).index()
        got = assert_same_encoding(hist, ref_hist)
        assert len(got["states"]) > 32 and got["n"][1] >= 1


@pytest.fixture(scope="module")
def mka_run(tmp_path_factory):
    """A live ycql multi-key-acid run (the reference test's one node and 4
    workers, for 3 s with the kill/restart every 1 s so that a restart
    falls inside the run), its generator seeded, judged key by key by the
    port's host `wgl` oracle (the suite's competition race with
    `device="cpu"` is `test_multi_key_acid_live`'s)."""
    gen.RNG.seed(26)
    test = yuga.yuga_test(_options(tmp_path_factory.mktemp("mka"),
                                   "ycql/multi-key-acid", time_limit=3,
                                   nemesis_interval=1.0))
    test["checker"] = checker.compose({"mka": independent.checker(
        checker.linearizable(multi_register(), algorithm="wgl",
                             device="cpu"))})
    return test, core.run(test)


def stored_history(test) -> History:
    return History([{**o, "value": kv_of(o.get("value"))}
                    for o in store.load_latest(test["store_root"])[
                        "history"]]).index()


def test_live_multi_key_history_matches_reference(mka_run):
    """The live multi-key-acid history, read back from the store, judged
    key by key by the port's `wgl` oracle and by the reference's: equal
    verdicts on every key, all True, equal to the run's own; a kill landed
    in the run."""
    test, done = mka_run
    hist = stored_history(test)
    assert [o.to_dict() for o in hist] == \
        [o.to_dict() for o in done["history"]]
    port = independent.checker(checker.linearizable(
        multi_register(), algorithm="wgl", device="cpu")).check(
            {}, hist, {})
    ref = ref_independent.checker(ref_checker.linearizable(
        ref_multi_register(), algorithm="wgl")).check(
            {}, ref_kv_history(hist), {})
    verdicts = {k: r["valid?"] for k, r in port["results"].items()}
    assert verdicts == {k: r["valid?"] for k, r in ref["results"].items()}
    assert verdicts == {k: r["valid?"]
                        for k, r in done["results"]["mka"]["results"].items()}
    assert len(verdicts) >= 3 and all(v is True for v in verdicts.values())
    assert any(o.process == "nemesis" and o.value == {"y1": "killed"}
               for o in hist)


def test_live_multi_key_encoding_matches_reference(mka_run):
    """The live run's largest key, encoded by both packages with the
    multi-register model: the same table, states, alphabet and window."""
    test, _ = mka_run
    hist = stored_history(test)
    ks = independent.history_keys(hist)
    subs = dict(zip(ks, independent.subhistories(hist, ks)))
    k = max(ks, key=lambda k: len(subs[k]))
    ref_sub = ref_independent.subhistory(k, ref_kv_history(hist))
    got = assert_same_encoding(subs[k], ref_sub)
    assert got["n"][0] >= 10


# -- the port's own choices ---------------------------------------------------

def test_ports_and_store_root_are_the_ports_own(tmp_path):
    assert (yuga.YCQL_BASE_PORT, yuga.YSQL_BASE_PORT) == (31500, 31550)
    # the reference's surfaces run on redis's and sqlite's ports; the
    # port's on blocks of their own, clear of the port's redis and sqlite,
    # of the reference's bases (21850-30680), below the ephemeral range
    lo, _ = ephemeral_range()
    for base in (yuga.YCQL_BASE_PORT, yuga.YSQL_BASE_PORT):
        assert base not in (redis.MINI_BASE_PORT, sqlite.MINI_BASE_PORT)
        assert 30680 < base and base + 50 <= lo
    test = {"nodes": ["y1", "y2"]}
    assert [yuga.ycql_port(test, n) for n in test["nodes"]] == \
        [yuga.YCQL_BASE_PORT, yuga.YCQL_BASE_PORT + 1]
    assert [yuga.ysql_port(test, n) for n in test["nodes"]] == \
        [yuga.YSQL_BASE_PORT, yuga.YSQL_BASE_PORT + 1]
    assert yuga.ycql_port({**test, "yuga_ycql_ports": {"y2": 4000}},
                          "y2") == 4000
    assert yuga.ysql_port({**test, "yuga_ysql_ports": {"y2": 4001}},
                          "y2") == 4001
    for which in yuga.WORKLOADS:
        t = yuga.yuga_test(_options(tmp_path, which))
        base = yuga.YCQL_BASE_PORT if which.startswith("ycql") \
            else yuga.YSQL_BASE_PORT
        assert t["db"].port(t, "y1") == base, which
        # every client's default port, the registry's redis register and
        # sqlite bank clients included
        assert t["client"].port_fn(t, "y1") == ("127.0.0.1", base), which
        assert t["client"].open(t, "y1").port_fn(t, "y1") == \
            ("127.0.0.1", base), which
    t = yuga.yuga_test({"nodes": ["y1"], "concurrency": 2, "device": "cpu"})
    assert t["store_root"] == os.path.join("store", "torch")
    assert t["name"] == "yuga-ysql-append"


def test_device_reaches_the_checks(tmp_path):
    for which in yuga.WORKLOADS:
        t = yuga.yuga_test(_options(tmp_path, which))
        chk = t["checker"].checker_map[which.replace("/", "-")]
        if which.endswith("single-key-acid"):
            chk = chk.checker.checker_map["linear"]
        elif which.endswith("multi-key-acid"):
            chk = chk.checker
            assert chk.model == multi_register()
        if which in yuga.DEVICE_WORKLOADS:
            assert chk.device == torch.device("cpu"), which
        else:
            assert getattr(chk, "device", None) is None, which


def test_missing_card_raises_before_setup(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    for which in yuga.DEVICE_WORKLOADS:
        with pytest.raises(RuntimeError, match="CUDA"):
            yuga.yuga_test({**_options(tmp_path, which), "device": None})
    # the sweep resolves it before it makes its first test
    sweep = yuga.yuga_tests({**_options(tmp_path, None), "device": None})
    with pytest.raises(RuntimeError, match="CUDA"):
        next(sweep)
    # a workload whose check runs on the host needs no card
    t = yuga.yuga_test({**_options(tmp_path, "ycql/bank"), "device": None})
    assert t["name"] == "yuga-ycql-bank"
    assert not (tmp_path / "cluster").exists()
