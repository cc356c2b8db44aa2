"""The port's hazelcast suite (`jepsen_tpu_torch/dbs/hazelcast.py`) held
against the JAX package: the twins of `tests/test_hazelcast.py` (the frame
codec, every primitive against the live mini server, the volatile-lock
violation proven through the mutex checker, fence monotonicity, all five
workloads live, the jar automation through the dummy remote), and parity
cases: the frames' bytes for every message type, the server's source byte
for byte, what each client sends and makes of the replies and of errors
(the fail / info split), the jar automation's and the mini server's
commands, the generated ops of every workload, `FenceChecker` on the same
histories, and one live lock history judged by both packages' `wgl` oracles
with the mutex model and by both `FenceChecker`s, its mutex encoding (table,
states, alphabet, window) the reference's.

Also: the port's ports and store root are its own, the `device` option
reaches the checks of `DEVICE_WORKLOADS`, and a missing card raises before
any node is set up. The suite checks on the CPU (`device="cpu"`).
"""

import builtins
import io
import os
import subprocess
import sys
import time

import pytest
import torch

import jepsen_tpu.control as ref_c
from jepsen_tpu import checker as ref_checker
from jepsen_tpu import generator as ref_gen
from jepsen_tpu.control.dummy import DummyRemote as RefDummyRemote
from jepsen_tpu.dbs import hazelcast as ref_hz
from jepsen_tpu.generator import testlib as ref_testlib
from jepsen_tpu.history import History as RefHistory
from jepsen_tpu.models import mutex as ref_mutex
from jepsen_tpu.ops import encode as ref_encode
from jepsen_tpu_torch import checker as jchecker
from jepsen_tpu_torch import core, store
from jepsen_tpu_torch import control as c
from jepsen_tpu_torch import generator as gen
from jepsen_tpu_torch import nemesis as jnemesis
from jepsen_tpu_torch.control.dummy import DummyRemote
from jepsen_tpu_torch.dbs import hazelcast as hz
from jepsen_tpu_torch.generator import testlib
from jepsen_tpu_torch.history import History, invoke, ok
from jepsen_tpu_torch.models import cas_register, mutex
from jepsen_tpu_torch.ops import encode
from conftest import kill_and_wait
from test_torch_galera import dummy_log, ref_history, workload_ops
from test_torch_logcabin import src_imports
from test_torch_sqlite import ephemeral_range
from test_torch_yuga import encoding_of

#: the twin fixture's server port, inside hazelcast's block (31700-31749)
FIXTURE_PORT = 31740


# -- codec -------------------------------------------------------------------

def test_frame_roundtrip():
    raw = hz.encode_frame(hz.LONG_CAS, 42, {"name": "n", "old": 1,
                                            "new": 2})
    msg_type, corr, payload = hz.read_frame(io.BytesIO(raw))
    assert (msg_type, corr) == (hz.LONG_CAS, 42)
    assert payload == {"name": "n", "old": 1, "new": 2}


# -- live mini server --------------------------------------------------------

def _start(path, port):
    srv_py = path / "minihz.py"
    if not srv_py.exists():
        srv_py.write_text(hz.MINIHZ_SRC)
    return subprocess.Popen(
        [sys.executable, str(srv_py), "--port", str(port),
         "--dir", str(path)], cwd=path)


def _connect(port, deadline_s=10):
    deadline = time.monotonic() + deadline_s
    while True:
        try:
            return hz.HzConn("127.0.0.1", port, timeout=2)
        except OSError:
            assert time.monotonic() < deadline, "never up"
            time.sleep(0.1)


@pytest.fixture()
def mini(tmp_path):
    port = FIXTURE_PORT
    proc = _start(tmp_path, port)
    conn = _connect(port)
    yield conn, port, tmp_path
    conn.close()
    proc.kill()
    proc.wait(timeout=10)


def test_atomic_long(mini):
    conn, _, _ = mini
    assert conn.add_and_get("c", 1) == 1
    assert conn.add_and_get("c", 1) == 2
    assert conn.long_get("c") == 2
    conn.long_set("c", 10)
    assert conn.long_cas("c", 10, 11) is True
    assert conn.long_cas("c", 10, 12) is False
    assert conn.long_get("c") == 11


def test_queue_fifo(mini):
    conn, _, _ = mini
    for i in range(3):
        conn.offer("q", i)
    assert conn.poll("q") == 0
    assert conn.poll("q") == 1
    assert conn.poll("q") == 2
    assert conn.poll("q") is None


def test_lock_fences_and_ownership(mini):
    conn, port, _ = mini
    f1 = conn.try_lock("l")
    assert f1 > hz.INVALID_FENCE
    c2 = hz.HzConn("127.0.0.1", port, timeout=2)
    assert c2.try_lock("l") == hz.INVALID_FENCE  # held
    with pytest.raises(hz.HzError, match="not-lock-owner"):
        c2.unlock("l")
    conn.unlock("l")
    f2 = c2.try_lock("l")
    assert f2 > f1  # fences are monotonic
    c2.close()


def test_map_replace(mini):
    conn, _, _ = mini
    assert conn.map_put_if_absent("m", "hi", [1]) is True
    assert conn.map_put_if_absent("m", "hi", [2]) is False
    assert conn.map_replace("m", "hi", [1], [1, 2]) is True
    assert conn.map_replace("m", "hi", [1], [9]) is False
    assert conn.map_get("m", "hi") == [1, 2]


def test_data_survives_kill_but_locks_do_not(mini, tmp_path):
    """The suite's headline: longs/queues/maps are durable, LOCKS ARE
    NOT — a kill -9 frees a held lock, and the resulting two-owners
    history FAILS the mutex checker (the reference's hazelcast lock
    anomaly, demonstrated deterministically on the port's server)."""
    conn, port, path = mini
    conn.add_and_get("durable", 7)
    conn.offer("dq", 42)
    fence = conn.try_lock("broken")
    assert fence > hz.INVALID_FENCE   # we hold the lock
    # kill -9 and restart
    kill_and_wait("minihz.py", port)
    proc = _start(path, port)
    try:
        c2 = _connect(port)
        # data survived
        assert c2.long_get("durable") == 7
        assert c2.poll("dq") == 42
        # ...but the lock is FREE while the first client still
        # believes it holds it
        fence2 = c2.try_lock("broken")
        assert fence2 > hz.INVALID_FENCE
        c2.close()
        # the history this produces is a mutex violation
        h = History([
            invoke(0, "acquire", None), ok(0, "acquire", fence),
            invoke(1, "acquire", None), ok(1, "acquire", fence2),
        ]).index()
        res = jchecker.linearizable(mutex(), algorithm="wgl",
                                    device="cpu").check({}, h, {})
        assert res["valid?"] is False
    finally:
        proc.kill()
        proc.wait(timeout=10)


# -- fence checker -----------------------------------------------------------

def test_fence_checker():
    good = History([
        invoke(0, "acquire", None), ok(0, "acquire", 1),
        invoke(0, "release", None), ok(0, "release", None),
        invoke(1, "acquire", None), ok(1, "acquire", 2),
    ]).index()
    assert hz.FenceChecker().check({}, good, {})["valid?"] is True
    bad = History([
        invoke(0, "acquire", None), ok(0, "acquire", 5),
        invoke(0, "release", None), ok(0, "release", None),
        invoke(1, "acquire", None), ok(1, "acquire", 5),
    ]).index()
    res = hz.FenceChecker().check({}, bad, {})
    assert res["valid?"] is False and res["errors"]


# -- full suites against LIVE mini servers -----------------------------------

def _options(tmp_path, which, **kw):
    return {"nodes": kw.pop("nodes", ["h1"]),
            "concurrency": kw.pop("concurrency", 4),
            "time_limit": kw.pop("time_limit", 8),
            "nemesis_interval": kw.pop("nemesis_interval", 2.5),
            "workload": which,
            "store_root": str(tmp_path / "store"),
            "sandbox": str(tmp_path / "cluster"), "device": "cpu", **kw}


@pytest.mark.parametrize("which", sorted(hz.WORKLOADS))
@pytest.mark.slow  # as its twin in tests/test_hazelcast.py
def test_full_suite_live(tmp_path, which):
    done = core.run(hz.hazelcast_test(_options(tmp_path, which)))
    res = done["results"]
    assert res["valid?"] is True, res


# -- jar automation ----------------------------------------------------------

def test_jar_commands():
    log: list = []
    db = hz.HazelcastDB()
    test = {"nodes": ["n1", "n2"]}
    with c.with_remote(DummyRemote(log)):
        with c.on("n1"):
            db.setup(test, "n1")
            db.kill(test, "n1")
    joined = "\n".join(x[1] for x in log if isinstance(x[1], str))
    assert "openjdk" in joined
    assert "hazelcast.xml" in joined
    assert "java" in joined
    conf = hz.HazelcastDB.config(test, "n1")
    assert "<member>n1</member>" in conf
    assert "<member>n2</member>" in conf
    assert 'tcp-ip enabled="true"' in conf


# -- parity with the reference ------------------------------------------------

MSG_TYPES = ("LONG_ADD_AND_GET", "LONG_GET", "LONG_SET", "LONG_CAS",
             "QUEUE_OFFER", "QUEUE_POLL", "LOCK_TRY", "LOCK_UNLOCK",
             "MAP_GET", "MAP_PUT_IF_ABSENT", "MAP_REPLACE")


def test_constants_match_reference():
    for name in MSG_TYPES + ("VERSION", "PORT", "INVALID_FENCE"):
        assert getattr(hz, name) == getattr(ref_hz, name), name
    assert len({getattr(hz, n) for n in MSG_TYPES}) == len(MSG_TYPES)
    for name in ("script", "pidfile", "logfile", "data_files"):
        assert getattr(hz.MiniHzDB, name) == getattr(ref_hz.MiniHzDB,
                                                     name), name
    assert hz.HazelcastDB.DIR == ref_hz.HazelcastDB.DIR
    assert sorted(hz.WORKLOADS) == sorted(ref_hz.WORKLOADS)
    assert set(hz.DEVICE_WORKLOADS) < set(hz.WORKLOADS)


def test_source_is_the_references_and_imports_neither_package():
    assert hz.MINIHZ_SRC == ref_hz.MINIHZ_SRC
    mods = src_imports(hz.MINIHZ_SRC)
    assert {"socketserver", "struct", "collections"} <= mods
    assert not mods & {"jepsen_tpu", "jepsen_tpu_torch", "jax", "torch"}
    # the lock state stays volatile: never logged, never replayed
    assert '"op": "lock"' not in hz.MINIHZ_SRC


# one request payload a message type, as the clients send them
PAYLOADS = {
    "LONG_ADD_AND_GET": {"name": "jepsen.atomic-long", "delta": 1},
    "LONG_GET": {"name": "jepsen.cas-long"},
    "LONG_SET": {"name": "jepsen.cas-long", "value": -3},
    "LONG_CAS": {"name": "jepsen.cas-long", "old": 1, "new": 2},
    "QUEUE_OFFER": {"name": "jepsen.queue", "value": 2 ** 40},
    "QUEUE_POLL": {"name": "jepsen.queue"},
    "LOCK_TRY": {"name": "jepsen.lock", "session": "s-1"},
    "LOCK_UNLOCK": {"name": "jepsen.lock", "session": "s-1"},
    "MAP_GET": {"name": "jepsen.map", "key": "hi"},
    "MAP_PUT_IF_ABSENT": {"name": "jepsen.map", "key": "hi",
                          "value": [1]},
    "MAP_REPLACE": {"name": "jepsen.map", "key": "hi", "old": [1],
                    "new": [1, 2]},
}


@pytest.mark.parametrize("msg", MSG_TYPES)
def test_frames_match_reference(msg):
    for corr in (1, 2 ** 40, -5):
        raw = hz.encode_frame(getattr(hz, msg), corr, PAYLOADS[msg])
        assert raw == ref_hz.encode_frame(getattr(ref_hz, msg), corr,
                                          PAYLOADS[msg])
        got = hz.read_frame(io.BytesIO(raw))
        assert got == ref_hz.read_frame(io.BytesIO(raw))
        assert got == (getattr(hz, msg), corr, PAYLOADS[msg])
    # a truncated frame is a connection error in both
    for mod in (hz, ref_hz):
        with pytest.raises(ConnectionError, match="short frame body"):
            mod.read_frame(io.BytesIO(raw[:-1]))


class FakeHz:
    """An in-memory connection with the live server's semantics (one
    session: a second try_lock on a held lock gets the invalid fence); each
    verb recorded in `sent`; a verb named in `fail_on` raises `exc`
    instead."""

    def __init__(self, mod, exc=None, fail_on=()):
        self.mod, self.exc, self.fail_on = mod, exc, fail_on
        self.longs, self.queue, self.maps = {}, [], {}
        self.held, self.fence, self.sent = False, 0, []

    def _call(self, verb, *args):
        self.sent.append((verb, *args))
        if verb in self.fail_on:
            raise self.exc

    def add_and_get(self, name, delta):
        self._call("add_and_get", name, delta)
        self.longs[name] = self.longs.get(name, 0) + delta
        return self.longs[name]

    def long_get(self, name):
        self._call("long_get", name)
        return self.longs.get(name, 0)

    def long_set(self, name, value):
        self._call("long_set", name, value)
        self.longs[name] = value

    def long_cas(self, name, old, new):
        self._call("long_cas", name, old, new)
        if self.longs.get(name, 0) != old:
            return False
        self.longs[name] = new
        return True

    def offer(self, name, value):
        self._call("offer", name, value)
        self.queue.append(value)

    def poll(self, name):
        self._call("poll", name)
        return self.queue.pop(0) if self.queue else None

    def try_lock(self, name):
        self._call("try_lock", name)
        if self.held:
            return self.mod.INVALID_FENCE
        self.held, self.fence = True, self.fence + 1
        return self.fence

    def unlock(self, name):
        self._call("unlock", name)
        if not self.held:
            raise self.mod.HzError("not-lock-owner")
        self.held = False

    def map_get(self, name, key):
        self._call("map_get", name, key)
        return self.maps.get(key)

    def map_put_if_absent(self, name, key, value):
        self._call("map_put_if_absent", name, key, value)
        if key in self.maps:
            return False
        self.maps[key] = value
        return True

    def map_replace(self, name, key, old, new):
        self._call("map_replace", name, key, old, new)
        if self.maps.get(key) != old:
            return False
        self.maps[key] = new
        return True

    def close(self):
        pass


VERBS = ("add_and_get", "long_get", "long_set", "long_cas", "offer", "poll",
         "try_lock", "unlock", "map_get", "map_put_if_absent", "map_replace")

# each client's ops: (f, value)
SESSIONS = {
    "HzIdClient": [("generate", None)] * 3,
    "HzCasLongClient": [("read", None), ("write", 3), ("cas", [3, 4]),
                        ("cas", [3, 5]), ("read", None)],
    "HzQueueClient": [("enqueue", 1), ("enqueue", 2), ("dequeue", None),
                      ("drain", None), ("dequeue", None)],
    "HzLockClient": [("acquire", None), ("acquire", None),
                     ("release", None), ("release", None),
                     ("acquire", None)],
    "HzMapSetClient": [("read", None), ("add", 3), ("add", 4),
                       ("read", None)],
}


def client_session(mod, name: str, conn) -> tuple:
    """The verbs the client `name` of `mod` sends over `conn` and its
    completions: (type, value, error, whether it still holds `conn`)."""
    cl = getattr(mod, name)().open({"nodes": ["h1"]}, "h1")
    out = []
    for f, v in SESSIONS[name]:
        cl.conn = conn
        done = cl.invoke({}, {"type": "invoke", "f": f, "value": v,
                              "process": 0})
        out.append((done["type"], done.get("value"), done.get("error"),
                    cl.conn is conn))
    return conn.sent, out


@pytest.mark.parametrize("name", sorted(SESSIONS))
def test_client_sessions_match_reference(name):
    got = client_session(hz, name, FakeHz(hz))
    assert got == client_session(ref_hz, name, FakeHz(ref_hz))
    assert got[1][0][0] == "ok"
    if name == "HzLockClient":
        assert [(t, e) for t, _, e, _ in got[1]] == [
            ("ok", None), ("fail", "held"), ("ok", None),
            ("fail", "not-lock-owner"), ("ok", None)]
        assert [v for _, v, _, _ in got[1]] == [1, None, None, None, 2]


# errors raised by the connection: (the module's HzError or a builtin, its
# message): the server's refusals, a protocol fault, and a refused, a reset
# and a timed-out connection
ERRORS = (
    ("HzError", "not-lock-owner"),
    ("HzError", "unsupported message type 9"),
    ("ConnectionError", "correlation mismatch"),
    ("ConnectionRefusedError", "[Errno 111] Connection refused"),
    ("ConnectionResetError", "[Errno 104] Connection reset by peer"),
    ("TimeoutError", "timed out"),
)


def error_of(mod, kind, msg):
    return (mod.HzError(msg) if kind == "HzError"
            else getattr(builtins, kind)(msg))


@pytest.mark.parametrize("kind,msg", ERRORS,
                         ids=[f"{k}:{m[:12]}" for k, m in ERRORS])
@pytest.mark.parametrize("name", sorted(SESSIONS))
def test_client_errors_match_reference(name, kind, msg):
    """Every verb raising: reads and dequeues / acquires fail, the rest go
    indefinite; a release refused as not-lock-owner fails definitely."""
    got = client_session(hz, name, FakeHz(hz, error_of(hz, kind, msg),
                                          VERBS))
    assert got == client_session(
        ref_hz, name, FakeHz(ref_hz, error_of(ref_hz, kind, msg), VERBS))
    for (t, _, err, held), (f, _) in zip(got[1], SESSIONS[name]):
        assert t in ("fail", "info"), (f, t)
        if f in ("read", "dequeue", "acquire"):
            assert t == "fail"


def jar_steps(mod):
    db = mod.HazelcastDB()
    test = {"nodes": ["n1", "n2", "n3"]}
    return [(n, (lambda n=n, f=f: getattr(db, f)(test, n)))
            for n in ("n1", "n3")
            for f in ("setup", "start", "kill", "teardown")], \
        [mod.HazelcastDB.config(test, n) for n in test["nodes"]], \
        db.log_files(test, "n1")


def test_jar_commands_match_reference():
    steps, confs, files = jar_steps(hz)
    ref_steps, ref_confs, ref_files = jar_steps(ref_hz)
    assert dummy_log(c, DummyRemote, steps) == \
        dummy_log(ref_c, RefDummyRemote, ref_steps)
    assert (confs, files) == (ref_confs, ref_files)


def test_mini_db_commands_match_reference():
    """The mini server's lifecycle: the same commands on the same ports."""
    def steps(mod):
        db = mod.MiniHzDB()
        test = {"nodes": ["h1", "h2"], "hazelcast_ports": {"h1": 40000,
                                                           "h2": 40001}}
        return [("h2", (lambda f=f: getattr(db, f)(test, "h2")))
                for f in ("setup", "kill", "start", "pause", "resume",
                          "teardown")]
    assert dummy_log(c, DummyRemote, steps(hz)) == \
        dummy_log(ref_c, RefDummyRemote, steps(ref_hz))


@pytest.mark.parametrize("which", sorted(hz.WORKLOADS))
def test_generated_ops_match_reference(which):
    got = workload_ops(hz, gen, testlib, which)
    assert got == workload_ops(ref_hz, ref_gen, ref_testlib, which)
    assert len(got) == 40


FENCE_HISTORIES = {
    "monotonic": [(0, "acquire", 1), (0, "release", None),
                  (1, "acquire", 2), (1, "release", None),
                  (2, "acquire", 7)],
    "repeated": [(0, "acquire", 5), (0, "release", None),
                 (1, "acquire", 5)],
    "falling": [(0, "acquire", 9), (1, "acquire", 3), (2, "acquire", 4),
                (3, "acquire", 1)],
    "no-fences": [(0, "release", None), (1, "acquire", "x")],
}


@pytest.mark.parametrize("name", sorted(FENCE_HISTORIES))
def test_fence_checker_matches_reference(name):
    ops = []
    for p, f, v in FENCE_HISTORIES[name]:
        ops += [invoke(p, f, None), ok(p, f, v)]
    h = History(ops).index()
    got = hz.FenceChecker().check({}, h, {})
    assert got == ref_hz.FenceChecker().check({}, ref_history(h), {})
    assert got["valid?"] is (name in ("monotonic", "no-fences"))


@pytest.fixture(scope="module")
def lock_run(tmp_path_factory):
    """A live lock run (the reference test's one mini node and 4 workers,
    for 3 s, fault-free as the workload is), its generator seeded, judged
    by the suite's own checks: the mutex's competition race on the CPU and
    the fences."""
    gen.RNG.seed(27)
    test = hz.hazelcast_test(_options(tmp_path_factory.mktemp("hz"), "lock",
                                      time_limit=3))
    return test, core.run(test)


def lock_history(test) -> History:
    return History(store.load_latest(test["store_root"])["history"]).index()


def test_live_lock_history_matches_reference(lock_run):
    """The live lock history, read back from the store, judged by both
    packages' `wgl` oracles with the mutex model and by both
    `FenceChecker`s: equal verdicts, True, equal to the suite's own; every
    ok acquire carries its fence."""
    test, done = lock_run
    hist = lock_history(test)
    assert [o.to_dict() for o in hist] == \
        [o.to_dict() for o in done["history"]]
    res = done["results"]["lock"]
    assert done["results"]["valid?"] is True
    port = jchecker.linearizable(mutex(), algorithm="wgl",
                                 device="cpu").check({}, hist, {})
    ref = ref_checker.linearizable(ref_mutex(), algorithm="wgl").check(
        {}, ref_history(hist), {})
    assert port["valid?"] is ref["valid?"] is res["mutex"]["valid?"] is True
    fences = hz.FenceChecker().check({}, hist, {})
    assert fences == ref_hz.FenceChecker().check({}, ref_history(hist), {})
    assert fences == res["fences"] and fences["acquisition-count"] >= 2
    acquired = [o for o in hist if o.f == "acquire" and o.is_ok]
    assert all(isinstance(o.value, int) and o.value > 0 for o in acquired)
    assert any(o.f == "release" and o.is_ok for o in hist)
    # fault-free: the workload's nemesis is a no-op, given nothing to do
    assert not any(o.process == "nemesis" for o in hist)


def test_live_lock_encoding_matches_reference(lock_run):
    """The live lock history encoded by both packages with the mutex model
    (each ok acquire's fence is its value, so each is an op of its own):
    the same table, states, alphabet and window, inside the 32-wide
    chunk kernel's reach."""
    test, _ = lock_run
    hist = lock_history(test)
    got = encoding_of(encode.encode(mutex(), hist.client_ops))
    want = encoding_of(ref_encode.encode(
        ref_mutex(), RefHistory([o.to_dict() for o in hist.client_ops])))
    assert got == want
    assert got["window"][0] <= 32
    assert any(f == "acquire" and v != "None" for f, v in got["alphabet"])


# -- the port's own choices ---------------------------------------------------

def test_ports_and_store_root_are_the_ports_own(tmp_path):
    assert hz.MINI_BASE_PORT == 31700
    assert hz.MINI_BASE_PORT != ref_hz.MINI_BASE_PORT
    # below the ephemeral range, clear of the reference's bases
    # (21850-30680), with room for five nodes and the twin fixture
    lo, _ = ephemeral_range()
    assert 30680 < hz.MINI_BASE_PORT and hz.MINI_BASE_PORT + 50 <= lo
    assert hz.MINI_BASE_PORT + 5 <= FIXTURE_PORT < hz.MINI_BASE_PORT + 50
    test = {"nodes": ["h1", "h2"]}
    assert [hz.mini_node_port(test, n) for n in test["nodes"]] == \
        [hz.MINI_BASE_PORT, hz.MINI_BASE_PORT + 1]
    assert hz.mini_node_port({**test, "hazelcast_ports": {"h2": 4000}},
                             "h2") == 4000
    for which in hz.WORKLOADS:
        t = hz.hazelcast_test(_options(tmp_path, which, nodes=["h1", "h2"]))
        assert t["store_root"] == str(tmp_path / "store")
        assert t["db"].port(t, "h2") == hz.MINI_BASE_PORT + 1
        # every worker drives the primary's server
        assert t["client"].port_fn(t, "h2") == ("127.0.0.1",
                                                hz.MINI_BASE_PORT)
    t = hz.hazelcast_test({"nodes": ["h1"], "concurrency": 2,
                           "device": "cpu"})
    assert t["store_root"] == os.path.join("store", "torch")
    assert t["name"] == "hazelcast-cas-long-mini"


def test_device_reaches_the_checks(tmp_path):
    for server in ("mini", "jar"):
        for which in hz.WORKLOADS:
            t = hz.hazelcast_test({**_options(tmp_path, which),
                                   "server": server})
            chk = t["checker"].checker_map[which]
            if which == "lock":
                assert isinstance(chk.checker_map["fences"],
                                  hz.FenceChecker)
                chk = chk.checker_map["mutex"]
                assert chk.model == mutex()
                # fault-free by design
                assert isinstance(t["nemesis"], jnemesis.Noop)
            elif which == "cas-long":
                assert chk.model == cas_register(0)
            if which in hz.DEVICE_WORKLOADS:
                assert chk.device == torch.device("cpu"), which
                assert chk.algorithm == "competition"
            else:
                assert getattr(chk, "device", None) is None, which


def test_missing_card_raises_before_setup(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    for which in hz.DEVICE_WORKLOADS:
        with pytest.raises(RuntimeError, match="CUDA"):
            hz.hazelcast_test({**_options(tmp_path, which),
                               "device": None})
    # the sweep resolves it before it makes its first test
    with pytest.raises(RuntimeError, match="CUDA"):
        next(hz.hazelcast_tests({**_options(tmp_path, None),
                                 "device": None}))
    assert not (tmp_path / "cluster").exists()
    # a workload whose check runs on the host needs no card
    t = hz.hazelcast_test({**_options(tmp_path, "queue"), "device": None})
    assert t["name"] == "hazelcast-queue-mini"
