"""The port's aerospike suite (`jepsen_tpu_torch/dbs/aerospike.py`) held
against the JAX package: the twins of `tests/test_aerospike.py` (the AS_MSG
codec, generation CAS and INCR against the live mini server, kill -9
durability, the generation-CAS spec explored exhaustively in both modes, all
three workloads live under the kill/restart nemesis, the .deb automation
through the dummy remote), and parity cases: the codec's bytes and its
round trip, the server's source byte for byte, what each client sends and
makes of the replies and of errors (the fail / info split), the .deb
automation's and the mini server's commands, the generated ops of every
workload, and one live cas-register history judged key by key by both
packages' `wgl` oracles.

Also: the port's ports and store root are its own, the `device` option
reaches the `cas-register` check, and a missing card raises before any node
is set up. The suite checks on the CPU (`device="cpu"`).
"""

import builtins
import os
import subprocess
import sys
import time
from collections import deque

import pytest
import torch

import jepsen_tpu.control as ref_c
from jepsen_tpu import checker as ref_checker
from jepsen_tpu import generator as ref_gen
from jepsen_tpu import independent as ref_independent
from jepsen_tpu.control.dummy import DummyRemote as RefDummyRemote
from jepsen_tpu.dbs import aerospike as ref_ae
from jepsen_tpu.generator import testlib as ref_testlib
from jepsen_tpu.models import cas_register as ref_cas_register
from jepsen_tpu_torch import checker, core, independent, store
from jepsen_tpu_torch import control as c
from jepsen_tpu_torch import generator as gen
from jepsen_tpu_torch.control.dummy import DummyRemote
from jepsen_tpu_torch.dbs import aerospike as ae
from jepsen_tpu_torch.generator import testlib
from jepsen_tpu_torch.history import History
from jepsen_tpu_torch.independent import tuple_
from jepsen_tpu_torch.models import cas_register
from conftest import kill_and_wait
from test_torch_etcd import kv_of, ref_kv_history
from test_torch_galera import dummy_log, workload_ops
from test_torch_logcabin import src_imports
from test_torch_sqlite import ephemeral_range
from test_torch_yuga import plain_value

#: the twin fixture's server port, inside aerospike's block (31650-31699)
FIXTURE_PORT = 31690


# -- codec units -------------------------------------------------------------

def test_msg_roundtrip():
    fields = [ae._enc_field(ae.FIELD_NAMESPACE, b"jepsen"),
              ae._enc_field(ae.FIELD_SET, b"cats"),
              ae._enc_field(ae.FIELD_KEY, b"7")]
    ops = [ae._enc_op(ae.OP_WRITE, "value", 42),
           ae._enc_op(ae.OP_WRITE, "note", "hi")]
    raw = ae.encode_msg(0, ae.INFO2_WRITE | ae.INFO2_GENERATION, 5,
                        fields, ops)
    # proto header: version 2, type 3, 48-bit size
    assert raw[0] == 2 and raw[1] == 3
    size = int.from_bytes(raw[2:8], "big")
    assert size == len(raw) - 8
    code, generation, bins = ae.decode_msg(raw[8:])
    assert generation == 5
    assert bins == {"value": 42, "note": "hi"}


# -- live mini server --------------------------------------------------------

@pytest.fixture()
def mini(tmp_path):
    srv_py = tmp_path / "miniaero.py"
    srv_py.write_text(ae.MINIAERO_SRC)
    port = FIXTURE_PORT
    proc = subprocess.Popen(
        [sys.executable, str(srv_py), "--port", str(port),
         "--dir", str(tmp_path)], cwd=tmp_path)
    deadline = time.monotonic() + 10
    conn = None
    while conn is None:
        try:
            conn = ae.AeroConn("127.0.0.1", port, timeout=2)
        except OSError:
            assert time.monotonic() < deadline, "never up"
            time.sleep(0.1)
    yield conn, port, tmp_path
    conn.close()
    proc.kill()
    proc.wait(timeout=10)


def test_put_fetch_generations(mini):
    conn, _, _ = mini
    assert conn.fetch("cats", "k") is None
    conn.put("cats", "k", {"value": 1})
    g1, bins = conn.fetch("cats", "k")
    assert bins == {"value": 1} and g1 == 1
    conn.put("cats", "k", {"value": 2})
    g2, bins = conn.fetch("cats", "k")
    assert bins == {"value": 2} and g2 == 2


def test_generation_cas(mini):
    conn, _, _ = mini
    conn.put("cats", "c", {"value": 10})
    g, _ = conn.fetch("cats", "c")
    # stale generation refused
    with pytest.raises(ae.AeroError) as exc:
        conn.put("cats", "c", {"value": 99}, expect_gen=g + 7)
    assert exc.value.code == ae.GENERATION_ERROR
    # matching generation commits
    conn.put("cats", "c", {"value": 11}, expect_gen=g)
    g2, bins = conn.fetch("cats", "c")
    assert bins["value"] == 11 and g2 == g + 1
    # expect_gen=0 is create-if-absent: existing record refuses
    with pytest.raises(ae.AeroError):
        conn.put("cats", "c", {"value": 0}, expect_gen=0)
    # ...and creates a missing one
    conn.put("cats", "fresh", {"value": 5}, expect_gen=0)
    assert conn.fetch("cats", "fresh")[1]["value"] == 5


def test_incr(mini):
    conn, _, _ = mini
    conn.put("counters", "n", {"value": 0})
    for _ in range(3):
        conn.add("counters", "n", "value", 1)
    assert conn.fetch("counters", "n")[1]["value"] == 3


def test_survives_kill(mini, tmp_path):
    conn, port, path = mini
    conn.put("cats", "durable", {"value": 77})
    kill_and_wait("miniaero.py", port)
    proc = subprocess.Popen(
        [sys.executable, str(path / "miniaero.py"), "--port",
         str(port), "--dir", str(path)], cwd=path)
    try:
        deadline = time.monotonic() + 10
        while True:
            # a connect may land in a dying socket's backlog: retry
            # the whole connect+fetch until the new server answers
            try:
                c2 = ae.AeroConn("127.0.0.1", port, timeout=2)
                g, bins = c2.fetch("cats", "durable")
                c2.close()
                break
            except (OSError, ConnectionError):
                assert time.monotonic() < deadline, "never back"
                time.sleep(0.1)
        assert bins["value"] == 77
    finally:
        proc.kill()
        proc.wait(timeout=10)


# -- the generation-CAS spec, explored exhaustively --------------------------
# Hand-translated action for action from the JAX package's
# `jepsen_tpu/dbs/spec/aerospike_gen.tla` (TLC is not in the CI image; this
# BFS plays its role), as `tests/test_aerospike.py` does.

CLIENTS = (0, 1)
VALUES = (1, 2)
MAX_GEN = 3


def spec_initial():
    # (gen, value, fetched, applied)
    return (0, 0, (-1,) * len(CLIENTS), frozenset())


def spec_successors(state, gen_checked):
    g, val, fetched, applied = state
    out = []
    for cl in CLIENTS:
        if g < MAX_GEN:
            f2 = fetched[:cl] + (g,) + fetched[cl + 1:]
            out.append(("fetch", (g, val, f2, applied)))
        if fetched[cl] != -1 and g < MAX_GEN:
            fr = fetched[:cl] + (-1,) + fetched[cl + 1:]
            if gen_checked and fetched[cl] != g:
                out.append(("gen-error", (g, val, fr, applied)))
            else:
                for v in VALUES:
                    out.append(("write", (
                        g + 1, v, fr,
                        applied | {(fetched[cl], g + 1)})))
    return out


def spec_explore(gen_checked):
    seen = {spec_initial()}
    frontier = deque(seen)
    violations = []
    while frontier:
        s = frontier.popleft()
        for _, s2 in spec_successors(s, gen_checked):
            if s2 in seen:
                continue
            seen.add(s2)
            frontier.append(s2)
            if any(new != old + 1 for old, new in s2[3]):
                violations.append(s2)
    return seen, violations


def test_spec_checked_mode_no_lost_updates():
    seen, violations = spec_explore(gen_checked=True)
    assert len(seen) > 50  # genuinely explored
    assert violations == []


def test_spec_relaxed_mode_finds_lost_update():
    _, violations = spec_explore(gen_checked=False)
    assert violations, "blind writes must lose updates"
    # a concrete clobber: some commit skipped a generation
    g, val, fetched, applied = violations[0]
    assert any(new != old + 1 for old, new in applied)


# -- full suites against LIVE mini servers -----------------------------------

def _options(tmp_path, which, **kw):
    return {"nodes": kw.pop("nodes", ["a1"]),
            "concurrency": kw.pop("concurrency", 4),
            "time_limit": kw.pop("time_limit", 8),
            "nemesis_interval": kw.pop("nemesis_interval", 2.5),
            "workload": which,
            "store_root": str(tmp_path / "store"),
            "sandbox": str(tmp_path / "cluster"), "device": "cpu", **kw}


@pytest.mark.parametrize("which", ["cas-register", "counter", "set"])
@pytest.mark.slow  # as its twin in tests/test_aerospike.py
def test_full_suite_live(tmp_path, which):
    done = core.run(ae.aerospike_test(_options(tmp_path, which)))
    res = done["results"]
    assert res["valid?"] is True, res


# -- real automation ---------------------------------------------------------

def test_deb_commands():
    log: list = []
    db = ae.AerospikeDB()
    test = {"nodes": ["n1", "n2"]}
    with c.with_remote(DummyRemote(log)):
        with c.on("n1"):
            db.setup(test, "n1")
            db.kill(test, "n1")
    cmds = [x[1] for x in log if isinstance(x[1], str)]
    joined = "\n".join(cmds)
    assert "aerospike-server" in joined
    assert "service aerospike start" in joined
    assert "asd" in joined  # killall path
    ups = [x[1] for x in log if isinstance(x[1], tuple)
           and x[1][0] == "upload"]
    assert any("aerospike.conf" in str(u[2]) for u in ups)
    conf = ae.AerospikeDB.conf(test, "n2")
    assert "mesh-seed-address-port n1 3002" in conf
    assert "replication-factor 3" in conf
    assert f"namespace {ae.NAMESPACE}" in conf


# -- parity with the reference ------------------------------------------------

def test_constants_match_reference():
    for name in ("NAMESPACE", "PORT", "PROTO_VERSION", "MSG_TYPE",
                 "INFO1_READ", "INFO2_WRITE", "INFO2_GENERATION", "OK",
                 "NOT_FOUND", "GENERATION_ERROR", "FIELD_NAMESPACE",
                 "FIELD_SET", "FIELD_KEY", "OP_READ", "OP_WRITE", "OP_INCR",
                 "T_INT", "T_STR"):
        assert getattr(ae, name) == getattr(ref_ae, name), name
    for name in ("script", "pidfile", "logfile", "data_files"):
        assert getattr(ae.MiniAeroDB, name) == \
            getattr(ref_ae.MiniAeroDB, name), name
    for cls in ("AeroCasRegisterClient", "AeroCounterClient",
                "AeroSetClient"):
        for name in ("SET", "KEY"):
            assert getattr(getattr(ae, cls), name, None) == \
                getattr(getattr(ref_ae, cls), name, None), (cls, name)
    assert sorted(ae.WORKLOADS) == sorted(ref_ae.WORKLOADS)
    assert set(ae.DEVICE_WORKLOADS) < set(ae.WORKLOADS)


def test_source_is_the_references_and_imports_neither_package():
    assert ae.MINIAERO_SRC == ref_ae.MINIAERO_SRC
    mods = src_imports(ae.MINIAERO_SRC)
    assert {"socketserver", "struct"} <= mods
    assert not mods & {"jepsen_tpu", "jepsen_tpu_torch", "jax", "torch"}


# (name, info1, info2, generation, bins as (op, name, value)): READ, WRITE
# and INCR with int and str bins, plain and with the generation flag (a
# CAS at generation 5, a create-if-absent at 0)
MSGS = (
    ("read", "INFO1_READ", None, 0, [("OP_READ", "", None)]),
    ("write-int", None, "INFO2_WRITE", 0, [("OP_WRITE", "value", 42)]),
    ("write-str", None, "INFO2_WRITE", 0, [("OP_WRITE", "note", "hi")]),
    ("write-both", None, "INFO2_WRITE", 0,
     [("OP_WRITE", "value", -7), ("OP_WRITE", "note", "1,2,3")]),
    ("cas", None, "GEN", 5, [("OP_WRITE", "value", 3)]),
    ("create", None, "GEN", 0, [("OP_WRITE", "value", "9")]),
    ("incr", None, "INFO2_WRITE", 0, [("OP_INCR", "value", 1)]),
    ("incr-neg", None, "INFO2_WRITE", 0, [("OP_INCR", "pounce", -2 ** 40)]),
)


def msg_bytes(mod, info1, info2, generation, bins, set_name="cats",
              key="7") -> bytes:
    fields = [mod._enc_field(mod.FIELD_NAMESPACE, mod.NAMESPACE.encode()),
              mod._enc_field(mod.FIELD_SET, set_name.encode()),
              mod._enc_field(mod.FIELD_KEY, key.encode())]
    def flag(name):
        if name == "GEN":
            return mod.INFO2_WRITE | mod.INFO2_GENERATION
        return 0 if name is None else getattr(mod, name)
    return mod.encode_msg(flag(info1), flag(info2), generation, fields,
                          [mod._enc_op(getattr(mod, op), n, v)
                           for op, n, v in bins])


@pytest.mark.parametrize("name,info1,info2,generation,bins", MSGS,
                         ids=[m[0] for m in MSGS])
def test_codec_matches_reference(name, info1, info2, generation, bins):
    raw = msg_bytes(ae, info1, info2, generation, bins)
    assert raw == msg_bytes(ref_ae, info1, info2, generation, bins)
    assert int.from_bytes(raw[2:8], "big") == len(raw) - 8
    got = ae.decode_msg(raw[8:])
    assert got == ref_ae.decode_msg(raw[8:])
    code, g, decoded = got
    assert g == generation
    # a READ's empty-named bin decodes as None; the rest round-trip
    assert decoded == {n: v for _, n, v in bins}
    flags = raw[8 + 1:8 + 3]
    assert bool(flags[1] & ae.INFO2_GENERATION) is (info2 == "GEN")


class FakeAero:
    """An in-memory connection with the live server's generation
    semantics: each verb recorded in `sent`; a verb named in `fail_on`
    raises `exc` instead."""

    def __init__(self, mod, exc=None, fail_on=()):
        self.mod, self.exc, self.fail_on = mod, exc, fail_on
        self.records, self.sent = {}, []

    def _call(self, verb, *args):
        self.sent.append((verb, *args))
        if verb in self.fail_on:
            raise self.exc

    def fetch(self, set_name, key):
        self._call("fetch", set_name, key)
        rec = self.records.get((set_name, key))
        return None if rec is None else (rec[0], dict(rec[1]))

    def put(self, set_name, key, bins, expect_gen=None):
        self._call("put", set_name, key, dict(bins), expect_gen)
        rec = self.records.get((set_name, key))
        if expect_gen is not None and (rec[0] if rec else 0) != expect_gen:
            raise self.mod.AeroError(self.mod.GENERATION_ERROR)
        g = rec[0] if rec else 0
        self.records[(set_name, key)] = [g + 1, {**(rec[1] if rec else {}),
                                                 **bins}]

    def add(self, set_name, key, bin_name, delta):
        self._call("add", set_name, key, bin_name, delta)
        rec = self.records.setdefault((set_name, key), [0, {}])
        rec[1][bin_name] = int(rec[1].get(bin_name, 0)) + delta
        rec[0] += 1

    def close(self):
        pass


# (client, whether it runs `setup`, its ops: (f, value), a ("kv", k, v)
# value made each package's `[k v]` tuple)
SESSIONS = {
    "AeroCasRegisterClient": (False, [
        ("read", ("kv", 1, None)), ("write", ("kv", 1, 3)),
        ("cas", ("kv", 1, [3, 4])), ("cas", ("kv", 1, [3, 5])),
        ("read", ("kv", 1, None)), ("cas", ("kv", 2, [0, 1]))]),
    "AeroCounterClient": (True, [("add", 1), ("add", 2), ("read", None)]),
    "AeroSetClient": (False, [("read", None), ("add", 3), ("add", 4),
                              ("read", None)]),
}


def client_session(mod, name: str, conn) -> tuple:
    """The verbs the client `name` of `mod` sends over `conn` (`setup`
    first where it seeds its record) and its completions: (type, value,
    error), and whether it still holds the connection."""
    seeds, ops = SESSIONS[name]
    cl = getattr(mod, name)().open({"nodes": ["a1"]}, "a1")
    cl.conn = conn
    if seeds and not conn.fail_on:
        cl.setup({})
    out = []
    for f, v in ops:
        if isinstance(v, tuple):
            v = (tuple_ if mod is ae else ref_independent.tuple_)(v[1], v[2])
        cl.conn = conn
        done = cl.invoke({}, {"type": "invoke", "f": f, "value": v,
                              "process": 0})
        out.append((done["type"], plain_value(done.get("value")),
                    done.get("error"), cl.conn is conn))
    return conn.sent, out


@pytest.mark.parametrize("name", sorted(SESSIONS))
def test_client_sessions_match_reference(name):
    got = client_session(ae, name, FakeAero(ae))
    assert got == client_session(ref_ae, name, FakeAero(ref_ae))
    assert all(t == "ok" for t, _, _, _ in got[1][:2])
    if name == "AeroCasRegisterClient":
        assert [t for t, *_ in got[1]] == ["ok", "ok", "ok", "fail", "ok",
                                           "fail"]
        assert got[1][3][2] == "skipping cas"


# errors raised by the connection: (the module's AeroError with a result
# code, or a builtin, and its message), the reference tests' and a refused
# and a reset connection's
ERRORS = (
    ("AeroError", 3), ("AeroError", 2), ("AeroError", 4),
    ("ConnectionError", "short proto header"),
    ("ConnectionRefusedError", "[Errno 111] Connection refused"),
    ("ConnectionResetError", "[Errno 104] Connection reset by peer"),
    ("TimeoutError", "timed out"),
)


def error_of(mod, kind, arg):
    return (mod.AeroError(arg) if kind == "AeroError"
            else getattr(builtins, kind)(arg))


@pytest.mark.parametrize("fail_on", [("fetch", "put", "add"), ("put",)],
                         ids=["every-verb", "writes"])
@pytest.mark.parametrize("kind,arg", ERRORS,
                         ids=[f"{k}:{str(a)[:12]}" for k, a in ERRORS])
@pytest.mark.parametrize("name", sorted(SESSIONS))
def test_client_errors_match_reference(name, kind, arg, fail_on):
    """The fail / info split: reads fail, mutations go indefinite, a
    generation mismatch on the CAS's write fails definitely, and the set's
    add retries a contended write."""
    got = client_session(ae, name, FakeAero(ae, error_of(ae, kind, arg),
                                            fail_on))
    assert got == client_session(
        ref_ae, name, FakeAero(ref_ae, error_of(ref_ae, kind, arg), fail_on))
    for (t, _, err, held), (f, _) in zip(got[1], SESSIONS[name][1]):
        if f == "read" and "fetch" in fail_on:
            assert (t, held) == ("fail", False)
        if t == "info":
            assert f != "read" and not held


def deb_steps(mod):
    db = mod.AerospikeDB()
    test = {"nodes": ["n1", "n2", "n3"]}
    return [(n, (lambda n=n, f=f: getattr(db, f)(test, n)))
            for n in ("n1", "n3")
            for f in ("setup", "start", "kill", "teardown")], \
        [mod.AerospikeDB.conf(test, n) for n in test["nodes"]], \
        db.log_files(test, "n1")


def test_deb_commands_match_reference():
    steps, confs, files = deb_steps(ae)
    ref_steps, ref_confs, ref_files = deb_steps(ref_ae)
    assert dummy_log(c, DummyRemote, steps) == \
        dummy_log(ref_c, RefDummyRemote, ref_steps)
    assert (confs, files) == (ref_confs, ref_files)


def test_mini_db_commands_match_reference():
    """The mini server's lifecycle: the same commands on the same ports."""
    def steps(mod):
        db = mod.MiniAeroDB()
        test = {"nodes": ["a1", "a2"], "aerospike_ports": {"a1": 40000,
                                                           "a2": 40001}}
        return [("a2", (lambda f=f: getattr(db, f)(test, "a2")))
                for f in ("setup", "kill", "start", "pause", "resume",
                          "teardown")]
    assert dummy_log(c, DummyRemote, steps(ae)) == \
        dummy_log(ref_c, RefDummyRemote, steps(ref_ae))


@pytest.mark.parametrize("which", sorted(ae.WORKLOADS))
def test_generated_ops_match_reference(which):
    got = workload_ops(ae, gen, testlib, which)
    assert got == workload_ops(ref_ae, ref_gen, ref_testlib, which)
    assert len(got) == 40


@pytest.fixture(scope="module")
def register_run(tmp_path_factory):
    """A live cas-register run (the reference test's one mini node and 4
    workers, for 3 s with the kill/restart every 1 s so that a restart
    falls inside the run), its generator seeded, judged key by key by the
    port's host `wgl` oracle (the suite's competition race with
    `device="cpu"` is `test_full_suite_live`'s)."""
    gen.RNG.seed(27)
    test = ae.aerospike_test(_options(tmp_path_factory.mktemp("aero"),
                                      "cas-register", time_limit=3,
                                      nemesis_interval=1.0))
    test["checker"] = checker.compose({"cas-register": independent.checker(
        checker.linearizable(cas_register(), algorithm="wgl",
                             device="cpu"))})
    return test, core.run(test)


def test_live_register_history_matches_reference(register_run):
    """The live cas-register history, read back from the store, judged key
    by key by the port's `wgl` oracle and by the reference's: equal
    verdicts on every key, all True, equal to the run's own; a kill landed
    in the run."""
    test, done = register_run
    hist = History([{**o, "value": kv_of(o.get("value"))}
                    for o in store.load_latest(test["store_root"])[
                        "history"]]).index()
    assert [o.to_dict() for o in hist] == \
        [o.to_dict() for o in done["history"]]
    port = independent.checker(checker.linearizable(
        cas_register(), algorithm="wgl", device="cpu")).check({}, hist, {})
    ref = ref_independent.checker(ref_checker.linearizable(
        ref_cas_register(), algorithm="wgl")).check(
            {}, ref_kv_history(hist), {})
    verdicts = {k: r["valid?"] for k, r in port["results"].items()}
    assert verdicts == {k: r["valid?"] for k, r in ref["results"].items()}
    assert verdicts == {
        k: r["valid?"]
        for k, r in done["results"]["cas-register"]["results"].items()}
    assert len(verdicts) >= 3 and all(v is True for v in verdicts.values())
    assert any(o.process == "nemesis" and o.value == {"a1": "killed"}
               for o in hist)
    assert any(o.f == "cas" and o.is_ok for o in hist)


# -- the port's own choices ---------------------------------------------------

def test_ports_and_store_root_are_the_ports_own(tmp_path):
    assert ae.MINI_BASE_PORT == 31650
    assert ae.MINI_BASE_PORT != ref_ae.MINI_BASE_PORT
    # below the ephemeral range, clear of the reference's bases
    # (21850-30680), with room for five nodes and the twin fixture
    lo, _ = ephemeral_range()
    assert 30680 < ae.MINI_BASE_PORT and ae.MINI_BASE_PORT + 50 <= lo
    assert ae.MINI_BASE_PORT + 5 <= FIXTURE_PORT < ae.MINI_BASE_PORT + 50
    test = {"nodes": ["a1", "a2"]}
    assert [ae.mini_node_port(test, n) for n in test["nodes"]] == \
        [ae.MINI_BASE_PORT, ae.MINI_BASE_PORT + 1]
    assert ae.mini_node_port({**test, "aerospike_ports": {"a2": 4000}},
                             "a2") == 4000
    for which in ae.WORKLOADS:
        t = ae.aerospike_test(_options(tmp_path, which, nodes=["a1", "a2"]))
        assert t["store_root"] == str(tmp_path / "store")
        assert t["db"].port(t, "a2") == ae.MINI_BASE_PORT + 1
        # every worker drives the primary's server
        assert t["client"].port_fn(t, "a2") == ("127.0.0.1",
                                                ae.MINI_BASE_PORT)
    t = ae.aerospike_test({"nodes": ["a1"], "concurrency": 2,
                           "device": "cpu"})
    assert t["store_root"] == os.path.join("store", "torch")
    assert t["name"] == "aerospike-cas-register-mini"


def test_device_reaches_the_checks(tmp_path):
    for server in ("mini", "deb"):
        for which in ae.WORKLOADS:
            t = ae.aerospike_test({**_options(tmp_path, which),
                                   "server": server})
            chk = t["checker"].checker_map[which]
            if which in ae.DEVICE_WORKLOADS:
                lin = chk.checker.checker_map["linear"]
                assert lin.device == torch.device("cpu")
                assert lin.algorithm == "competition"
                assert lin.model == cas_register()
            else:
                assert getattr(chk, "device", None) is None, which


def test_missing_card_raises_before_setup(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    for server in ("mini", "deb"):
        with pytest.raises(RuntimeError, match="CUDA"):
            ae.aerospike_test({**_options(tmp_path, "cas-register"),
                               "server": server, "device": None})
    # the sweep resolves it before it makes its first test
    with pytest.raises(RuntimeError, match="CUDA"):
        next(ae.aerospike_tests({**_options(tmp_path, None),
                                 "device": None}))
    assert not (tmp_path / "cluster").exists()
    # a workload whose check runs on the host needs no card
    t = ae.aerospike_test({**_options(tmp_path, "counter"), "device": None})
    assert t["name"] == "aerospike-counter-mini"
