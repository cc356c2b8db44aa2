"""The port's rethinkdb suite (`jepsen_tpu_torch/dbs/rethinkdb.py`) held
against the JAX package: the twins of `tests/test_rethinkdb.py` (the ReQL
term shapes, the V0_4 handshake, CRUD and cas-by-branch against the live
mini server, the admin and reconfigure queries, kill -9 durability, the
durability matrix and the reconfigure variant live, the deb automation
through the dummy remote), and parity cases: the handshake's and every
query's bytes and what `run` makes of each response, the read, write, cas,
write-acks and reconfigure term ASTs, the server's source byte for byte,
what the client sends and makes of the replies and of errors (the fail /
info split), the reconfigure nemesis's queries and ops, the test-all
matrix, the deb automation's and the mini server's commands, and the
generated ops.

Also: the port's ports and store root are its own, the `device` option
reaches the register's check in every test of the matrix, and a missing
card raises before any node is set up. The suite checks on the CPU
(`device="cpu"`).
"""

import builtins
import io
import json
import os
import struct
import subprocess
import sys
import time

import pytest
import torch

import jepsen_tpu.control as ref_c
from jepsen_tpu import generator as ref_gen
from jepsen_tpu import independent as ref_independent
from jepsen_tpu.control.dummy import DummyRemote as RefDummyRemote
from jepsen_tpu.dbs import rethinkdb as ref_rt
from jepsen_tpu.generator import testlib as ref_testlib
from jepsen_tpu_torch import control as c
from jepsen_tpu_torch import core
from jepsen_tpu_torch import generator as gen
from jepsen_tpu_torch.control.dummy import DummyRemote
from jepsen_tpu_torch.dbs import rethinkdb as rt
from jepsen_tpu_torch.generator import testlib
from jepsen_tpu_torch.independent import tuple_
from jepsen_tpu_torch.models import cas_register
from conftest import kill_and_wait
from test_torch_galera import dummy_log
from test_torch_logcabin import src_imports
from test_torch_sqlite import ephemeral_range
from test_torch_yuga import plain_value

#: the twin fixture's server port, inside rethinkdb's block (31800-31849)
FIXTURE_PORT = 31840


# -- term builders -----------------------------------------------------------

def test_term_shapes():
    t = rt.t_read("jepsen", "cas", "5", "majority")
    assert t[0] == rt.DEFAULT
    get_field = t[1][0]
    assert get_field[0] == rt.GET_FIELD
    row = get_field[1][0]
    assert row[0] == rt.GET
    table = row[1][0]
    assert table[0] == rt.TABLE and table[2] == {"read_mode":
                                                 "majority"}
    w = rt.t_write("jepsen", "cas", "5", 3)
    assert w[0] == rt.INSERT and w[2] == {"conflict": "update"}
    cas = rt.t_cas("jepsen", "cas", "5", 1, 2)
    assert cas[0] == rt.UPDATE
    fn = cas[1][1]
    assert fn[0] == rt.FUNC and fn[1][1][0] == rt.BRANCH


# -- live mini server --------------------------------------------------------

@pytest.fixture()
def mini(tmp_path):
    srv_py = tmp_path / "minirethink.py"
    srv_py.write_text(rt.MINIRETHINK_SRC)
    port = FIXTURE_PORT
    proc = subprocess.Popen(
        [sys.executable, str(srv_py), "--port", str(port),
         "--dir", str(tmp_path)], cwd=tmp_path)
    deadline = time.monotonic() + 10
    conn = None
    while conn is None:
        try:
            conn = rt.ReqlConn("127.0.0.1", port, timeout=2)
        except OSError:
            assert time.monotonic() < deadline, "never up"
            time.sleep(0.1)
    yield conn, port, tmp_path
    conn.close()
    proc.kill()
    proc.wait(timeout=10)


def test_handshake_and_crud(mini):
    conn, _, _ = mini
    # read of a missing doc returns the DEFAULT fallback
    assert conn.run(rt.t_read("jepsen", "cas", "k1")) is None
    res = conn.run(rt.t_write("jepsen", "cas", "k1", 7))
    assert res["inserted"] == 1 and res["errors"] == 0
    assert conn.run(rt.t_read("jepsen", "cas", "k1")) == 7
    # conflict=update overwrites
    res = conn.run(rt.t_write("jepsen", "cas", "k1", 9))
    assert res["replaced"] == 1
    assert conn.run(rt.t_read("jepsen", "cas", "k1")) == 9


def test_cas_branch_semantics(mini):
    conn, _, _ = mini
    conn.run(rt.t_write("jepsen", "cas", "c", 1))
    # matching old value: replaced
    res = conn.run(rt.t_cas("jepsen", "cas", "c", 1, 2))
    assert res["errors"] == 0 and res["replaced"] == 1
    assert conn.run(rt.t_read("jepsen", "cas", "c")) == 2
    # stale old value: the branch ERRORs, nothing replaced
    res = conn.run(rt.t_cas("jepsen", "cas", "c", 1, 3))
    assert res["errors"] == 1 and res["replaced"] == 0
    assert res["first_error"] == "abort"
    assert conn.run(rt.t_read("jepsen", "cas", "c")) == 2


def test_admin_and_reconfigure(mini):
    conn, _, _ = mini
    res = conn.run(rt.t_write_acks("single", ["n1", "n2"]))
    assert res["replaced"] == 1
    res = conn.run(rt.t_reconfigure("jepsen", "cas", "n2",
                                    ["n1", "n2"]))
    assert res["reconfigured"] == 1


def test_survives_kill(mini, tmp_path):
    conn, port, path = mini
    conn.run(rt.t_write("jepsen", "cas", "durable", 42))
    kill_and_wait("minirethink.py", port)
    proc = subprocess.Popen(
        [sys.executable, str(path / "minirethink.py"), "--port",
         str(port), "--dir", str(path)], cwd=path)
    try:
        deadline = time.monotonic() + 10
        while True:
            try:
                c2 = rt.ReqlConn("127.0.0.1", port, timeout=2)
                out = c2.run(rt.t_read("jepsen", "cas", "durable"))
                c2.close()
                break
            except (OSError, ConnectionError):
                assert time.monotonic() < deadline, "never back"
                time.sleep(0.1)
        assert out == 42
    finally:
        proc.kill()
        proc.wait(timeout=10)


# -- full suites against LIVE mini servers -----------------------------------

def _options(tmp_path, **kw):
    return {"nodes": kw.pop("nodes", ["r1"]),
            "concurrency": kw.pop("concurrency", 4),
            "time_limit": kw.pop("time_limit", 8),
            "nemesis_interval": kw.pop("nemesis_interval", 2.5),
            "per_key_limit": 30,
            "store_root": str(tmp_path / "store"),
            "sandbox": str(tmp_path / "cluster"), "device": "cpu", **kw}


@pytest.mark.slow  # as its twin in tests/test_rethinkdb.py
def test_full_suite_live(tmp_path):
    done = core.run(rt.rethinkdb_test(
        _options(tmp_path, write_acks="majority",
                 read_mode="majority")))
    res = done["results"]
    assert res["valid?"] is True, res


@pytest.mark.slow  # as its twin in tests/test_rethinkdb.py
def test_full_suite_reconfigure(tmp_path):
    done = core.run(rt.rethinkdb_test(
        _options(tmp_path, reconfigure=True)))
    res = done["results"]
    assert res["valid?"] is True, res
    # the reconfigure nemesis actually drove topology churn
    reconfs = [op for op in done["history"]
               if op.f == "reconfigure" and op.is_info
               and isinstance(op.value, dict)
               and op.value.get("reconfigured") == 1]
    assert reconfs, "no successful reconfigure landed"


def test_tests_matrix(tmp_path):
    tests = list(rt.rethinkdb_tests(_options(tmp_path)))
    names = [t["name"] for t in tests]
    assert len(tests) == 4  # 3 durability combos + reconfigure
    assert len(set(names)) == 4
    assert any("reconfigure" in n for n in names)
    assert any("wsingle-rsingle" in n for n in names)


# -- deb automation ----------------------------------------------------------

def test_deb_commands():
    log: list = []
    db = rt.RethinkDB()
    test = {"nodes": ["n1", "n2", "n3"]}
    with c.with_remote(DummyRemote(log)):
        with c.on("n2"):
            db.setup(test, "n2")
            db.kill(test, "n2")
    cmds = [x[1] for x in log if isinstance(x[1], str)]
    joined = "\n".join(cmds)
    assert "rethinkdb=" in joined
    assert "service rethinkdb start" in joined
    conf = rt.RethinkDB.config(test, "n2")
    # joins point at the OTHER nodes only
    assert "join=n1:29015" in conf and "join=n3:29015" in conf
    assert "join=n2:29015" not in conf
    assert "bind=all" in conf


# -- parity with the reference ------------------------------------------------

TERMS = ("MAKE_ARRAY", "DB", "TABLE", "GET", "EQ", "GET_FIELD", "UPDATE",
         "INSERT", "BRANCH", "FUNC", "VAR", "ERROR", "DEFAULT", "RECONFIGURE")


def test_constants_match_reference():
    for name in TERMS + ("VERSION", "PORT", "V0_4", "PROTO_JSON", "START",
                         "SUCCESS_ATOM", "RUNTIME_ERROR", "AXES"):
        assert getattr(rt, name) == getattr(ref_rt, name), name
    for name in ("script", "pidfile", "logfile", "data_files"):
        assert getattr(rt.MiniRethinkDB, name) == \
            getattr(ref_rt.MiniRethinkDB, name), name
    for name in ("DB_NAME", "TBL"):
        assert getattr(rt.RethinkCasClient, name) == \
            getattr(ref_rt.RethinkCasClient, name), name


def test_source_is_the_references_and_imports_neither_package():
    assert rt.MINIRETHINK_SRC == ref_rt.MINIRETHINK_SRC
    assert "__V04_MAGIC__" not in rt.MINIRETHINK_SRC
    assert str(rt.V0_4) in rt.MINIRETHINK_SRC
    mods = src_imports(rt.MINIRETHINK_SRC)
    assert {"socketserver", "struct", "json"} <= mods
    assert not mods & {"jepsen_tpu", "jepsen_tpu_torch", "jax", "torch"}


# each builder's argument tuples
TERM_ARGS = {
    "t_table": [("jepsen", "cas"), ("jepsen", "cas", "majority"),
                ("rethinkdb", "table_config", None)],
    "t_read": [("jepsen", "cas", "5"), ("jepsen", "cas", "k", "single"),
               ("jepsen", "cas", "7", "majority")],
    "t_write": [("jepsen", "cas", "5", 3), ("jepsen", "cas", "k", -1)],
    "t_cas": [("jepsen", "cas", "5", 1, 2),
              ("jepsen", "cas", "k", None, 4, "majority"),
              ("jepsen", "cas", "k", 0, 0, "single")],
    "t_write_acks": [("single", ["n1"]), ("majority", ["n1", "n2", "n3"])],
    "t_reconfigure": [("jepsen", "cas", "n2", ["n1", "n2"]),
                      ("jepsen", "cas", "n1", ["n1"])],
}


@pytest.mark.parametrize("builder", sorted(TERM_ARGS))
def test_term_asts_match_reference(builder):
    for args in TERM_ARGS[builder]:
        got = getattr(rt, builder)(*args)
        assert got == getattr(ref_rt, builder)(*args), args
        assert json.dumps(got) == json.dumps(getattr(ref_rt, builder)(*args))


class Sock:
    """A socket whose reads are scripted: what the client sends, and the
    server's bytes, read in turn through `makefile`."""

    def __init__(self, replies: bytes):
        self.sent, self.replies = bytearray(), replies

    def settimeout(self, t):
        pass

    def sendall(self, b):
        self.sent += b

    def makefile(self, mode):
        return io.BytesIO(self.replies)

    def close(self):
        pass


def response(token: int, body: dict) -> bytes:
    raw = json.dumps(body).encode()
    return struct.pack("<Q", token) + struct.pack("<I", len(raw)) + raw


# the queries, in turn, and the server's response to each
QUERIES = (
    (("t_write_acks", "majority", ["r1"]), {"t": 1, "r": [{"replaced": 1,
                                                           "errors": 0}]}),
    (("t_read", "jepsen", "cas", "1", "majority"), {"t": 1, "r": [None]}),
    (("t_write", "jepsen", "cas", "1", 3), {"t": 1, "r": [{"inserted": 1}]}),
    (("t_cas", "jepsen", "cas", "1", 3, 4, "majority"),
     {"t": 1, "r": [{"replaced": 1, "errors": 0}]}),
    (("t_read", "jepsen", "cas", "1"), {"t": 18, "r": ["unsupported"]}),
    (("t_read", "jepsen", "cas", "1"), {"t": 17, "r": []}),
)


def wire_session(mod, monkeypatch, gate=b"SUCCESS\x00") -> tuple:
    """A connection's handshake and QUERIES over a scripted socket: the
    bytes the client sent, and what each `run` returned or raised."""
    replies = gate + b"".join(response(i, body)
                              for i, (_, body) in enumerate(QUERIES, 1))
    sock = Sock(replies)
    monkeypatch.setattr(mod.socket, "create_connection",
                        lambda addr, timeout=None: sock)
    try:
        conn = mod.ReqlConn("r1", 1)
    except mod.ReqlError as e:
        return bytes(sock.sent), [("ReqlError", str(e))]
    out = []
    for (builder, *args), _ in QUERIES:
        try:
            out.append(("ok", conn.run(getattr(mod, builder)(*args))))
        except mod.ReqlError as e:
            out.append(("ReqlError", str(e)))
    return bytes(sock.sent), out


@pytest.mark.parametrize("gate", [b"SUCCESS\x00",
                                  b"ERROR: unknown protocol\x00"])
def test_wire_bytes_match_reference(monkeypatch, gate):
    got = wire_session(rt, monkeypatch, gate)
    assert got == wire_session(ref_rt, monkeypatch, gate)
    sent, out = got
    # V0_4 magic, an empty auth key, the JSON protocol word
    assert sent[:12] == struct.pack("<III", 0x400C2D20, 0, 0x7E6970C7)
    if gate.startswith(b"SUCCESS"):
        assert out[-2:] == [("ReqlError", "unsupported"),
                            ("ReqlError", "response type 17")]
        token, n = struct.unpack("<QI", sent[12:24])
        assert token == 1 and json.loads(sent[24:24 + n])[0] == rt.START
    else:
        assert out == [("ReqlError", "ERROR: unknown protocol\x00")]


class FakeReql:
    """A connection that records each term and answers it from `replies`
    in turn; with `exc`, every `run` raises it."""

    def __init__(self, replies=(), exc=None):
        self.replies, self.exc, self.sent = list(replies), exc, []

    def run(self, term):
        self.sent.append(term)
        if self.exc is not None:
            raise self.exc
        return self.replies.pop(0)

    def close(self):
        pass


CLIENT_TEST = {"nodes": ["r1", "r2"], "write_acks": "single",
               "read_mode": "single"}
# the ops, each a ("kv", k, v) value made each package's `[k v]` tuple,
# and the server's reply to each
CLIENT_OPS = (
    (("read", 1, None), 3),
    (("read", 2, None), None),
    (("write", 1, 4), {"inserted": 0, "replaced": 1, "errors": 0}),
    (("write", 1, 5), {"errors": 1, "first_error": "x"}),
    (("cas", 1, [4, 6]), {"replaced": 1, "errors": 0}),
    (("cas", 1, [4, 7]), {"replaced": 0, "errors": 1,
                          "first_error": "abort"}),
)


def client_session(mod, exc=None) -> tuple:
    """The terms the client sends (its `setup`'s admin update first) and its
    completions: (type, value, error, whether it still holds the
    connection)."""
    conn = FakeReql([{"replaced": 1}] + [r for _, r in CLIENT_OPS], exc)
    cl = mod.RethinkCasClient().open(CLIENT_TEST, "r1")
    cl.conn = conn
    if exc is None:
        cl.setup(CLIENT_TEST)
    out = []
    for (f, k, v), _ in CLIENT_OPS:
        cl.conn = conn
        kv = (tuple_ if mod is rt else ref_independent.tuple_)(k, v)
        done = cl.invoke(CLIENT_TEST, {"type": "invoke", "f": f,
                                       "value": kv, "process": 0})
        out.append((done["type"], plain_value(done.get("value")),
                    done.get("error"), cl.conn is conn))
    return conn.sent, out


def test_client_session_matches_reference():
    got = client_session(rt)
    assert got == client_session(ref_rt)
    sent, out = got
    assert [t for t, *_ in out] == ["ok", "ok", "ok", "info", "ok", "fail"]
    assert out[0][1] == ("kv", 1, 3) and out[1][1] == ("kv", 2, None)
    # the admin update, then the reads at the test's read mode
    assert sent[0] == rt.t_write_acks("single", ["r1", "r2"])
    assert sent[1] == rt.t_read("jepsen", "cas", "1", "single")


ERRORS = (
    ("ReqlError", "abort"), ("ReqlError", "response type 17"),
    ("ConnectionError", "handshake EOF"),
    ("ConnectionRefusedError", "[Errno 111] Connection refused"),
    ("ConnectionResetError", "[Errno 104] Connection reset by peer"),
    ("TimeoutError", "timed out"),
)


@pytest.mark.parametrize("kind,msg", ERRORS,
                         ids=[f"{k}:{m[:12]}" for k, m in ERRORS])
def test_client_errors_match_reference(kind, msg):
    """Every query raising: reads fail, writes and cas go indefinite, and
    the connection is dropped."""
    def exc(mod):
        return (mod.ReqlError(msg) if kind == "ReqlError"
                else getattr(builtins, kind)(msg))
    got = client_session(rt, exc(rt))
    assert got == client_session(ref_rt, exc(ref_rt))
    for (t, _, err, held), ((f, _, _), _) in zip(got[1], CLIENT_OPS):
        assert t == ("fail" if f == "read" else "info") and not held
        assert err == msg[:200]


def nemesis_session(mod, g_mod, fail=None) -> tuple:
    """The reconfigure nemesis's ops over a recording connection (its
    replica sets drawn from the seeded generator RNG): the terms sent, the
    nodes connected to, and the completed ops."""
    g_mod.RNG.seed(27)
    conns, nodes = [], []

    def conn_fn(test, node):
        nodes.append(node)
        conns.append(FakeReql([{"reconfigured": 1}] * 8, fail))
        return conns[-1]
    nem = mod.ReconfigureNemesis("jepsen", "cas", conn_fn)
    assert nem.setup({}) is nem
    test = {"nodes": ["n1", "n2", "n3", "n4", "n5"]}
    out = [nem.invoke(test, {"type": "info", "f": "reconfigure",
                             "process": "nemesis"}) for _ in range(6)]
    with pytest.raises(ValueError, match="unknown nemesis op"):
        nem.invoke(test, {"type": "info", "f": "start"})
    return [t for cn in conns for t in cn.sent], nodes, out


@pytest.mark.parametrize("fail", [None, "ReqlError", "ConnectionRefusedError"])
def test_reconfigure_nemesis_matches_reference(fail):
    def exc(mod):
        if fail is None:
            return None
        return (mod.ReqlError("x") if fail == "ReqlError"
                else ConnectionRefusedError("refused"))
    got = nemesis_session(rt, gen, exc(rt))
    assert got == nemesis_session(ref_rt, ref_gen, exc(ref_rt))
    terms, nodes, out = got
    assert len(terms) == len(nodes) == 6
    assert all(t[0] == rt.RECONFIGURE for t in terms)
    for o, node in zip(out, nodes):
        assert o["type"] == "info"
        if fail is None:
            assert o["value"]["primary"] == node
            assert node in o["value"]["replicas"]
            assert o["value"]["reconfigured"] == 1
        else:
            assert "error" in o["value"]


PLAIN_KEYS = ("name", "store_root", "nodes", "concurrency", "write_acks",
              "read_mode")


def matrix(mod, tmp_path, **kw) -> list:
    return [{k: t.get(k) for k in PLAIN_KEYS}
            | {"db": type(t["db"]).__name__,
               "nemesis": type(t["nemesis"]).__name__,
               "checks": sorted(t["checker"].checker_map)}
            for t in mod.rethinkdb_tests(_options(tmp_path, **kw))]


@pytest.mark.parametrize("kw", [{}, {"name": "docs"},
                                {"server": "deb", "write_acks": "single"}],
                         ids=["default", "named", "deb"])
def test_tests_matrix_matches_reference(tmp_path, kw):
    got = matrix(rt, tmp_path, **kw)
    assert got == matrix(ref_rt, tmp_path, **kw)
    assert [(t["write_acks"], t["read_mode"]) for t in got[:3]] == rt.AXES
    assert got[3]["nemesis"] != got[0]["nemesis"]


def test_generated_ops_match_reference(tmp_path):
    """The first 60 ops of the reconfigure test's generator (the register's
    keyed ops beside the nemesis's cycle, its sleeps 1 ms), every op
    completing ok 1 ms after its invocation."""
    def ops(mod, g_mod, tl):
        test = mod.rethinkdb_test(_options(tmp_path, reconfigure=True,
                                           nemesis_interval=0.001))
        out = []
        for o in tl.simulate(g_mod.limit(60, test["generator"]),
                             lambda ctx, inv: {**inv, "type": "ok",
                                               "time": inv["time"] + 10 ** 6},
                             None, None):
            if o["type"] == "invoke" or o["process"] == "nemesis":
                v = o.get("value")
                out.append((o["process"], o["f"],
                            ("kv", v.k, v.v) if hasattr(v, "k") else v))
        return out
    got = ops(rt, gen, testlib)
    assert got == ops(ref_rt, ref_gen, ref_testlib)
    assert {f for _, f, _ in got} >= {"read", "write", "cas",
                                      "reconfigure", "start"}


def deb_steps(mod):
    db = mod.RethinkDB("2.3.6")
    test = {"nodes": ["n1", "n2", "n3"]}
    return [(n, (lambda n=n, f=f: getattr(db, f)(test, n)))
            for n in ("n1", "n2")
            for f in ("setup", "start", "kill", "teardown")], \
        [mod.RethinkDB.config(test, n) for n in test["nodes"]], \
        db.log_files(test, "n1")


def test_deb_commands_match_reference():
    steps, confs, files = deb_steps(rt)
    ref_steps, ref_confs, ref_files = deb_steps(ref_rt)
    assert dummy_log(c, DummyRemote, steps) == \
        dummy_log(ref_c, RefDummyRemote, ref_steps)
    assert (confs, files) == (ref_confs, ref_files)


def test_mini_db_commands_match_reference():
    """The mini server's lifecycle: the same commands on the same ports."""
    def steps(mod):
        db = mod.MiniRethinkDB()
        test = {"nodes": ["r1", "r2"], "rethinkdb_ports": {"r1": 40000,
                                                           "r2": 40001}}
        return [("r2", (lambda f=f: getattr(db, f)(test, "r2")))
                for f in ("setup", "kill", "start", "pause", "resume",
                          "teardown")]
    assert dummy_log(c, DummyRemote, steps(rt)) == \
        dummy_log(ref_c, RefDummyRemote, steps(ref_rt))


# -- the port's own choices ---------------------------------------------------

def test_ports_and_store_root_are_the_ports_own(tmp_path):
    assert rt.MINI_BASE_PORT == 31800
    assert rt.MINI_BASE_PORT != ref_rt.MINI_BASE_PORT
    # below the ephemeral range, clear of the reference's bases
    # (21850-30680), with room for five nodes and the twin fixture
    lo, _ = ephemeral_range()
    assert 30680 < rt.MINI_BASE_PORT and rt.MINI_BASE_PORT + 50 <= lo
    assert rt.MINI_BASE_PORT + 5 <= FIXTURE_PORT < rt.MINI_BASE_PORT + 50
    test = {"nodes": ["r1", "r2"]}
    assert [rt.mini_node_port(test, n) for n in test["nodes"]] == \
        [rt.MINI_BASE_PORT, rt.MINI_BASE_PORT + 1]
    assert rt.mini_node_port({**test, "rethinkdb_ports": {"r2": 4000}},
                             "r2") == 4000
    t = rt.rethinkdb_test(_options(tmp_path, nodes=["r1", "r2"]))
    assert t["store_root"] == str(tmp_path / "store")
    assert t["db"].port(t, "r2") == rt.MINI_BASE_PORT + 1
    # every worker drives the primary's server
    assert t["client"].port_fn(t, "r2") == ("127.0.0.1", rt.MINI_BASE_PORT)
    t = rt.rethinkdb_test({"nodes": ["r1"], "concurrency": 2,
                           "device": "cpu"})
    assert t["store_root"] == os.path.join("store", "torch")
    assert t["name"] == "rethinkdb-cas-wmajority-rmajority-mini"


def test_device_reaches_the_checks(tmp_path):
    for server in ("mini", "deb"):
        tests = list(rt.rethinkdb_tests({**_options(tmp_path),
                                         "server": server}))
        assert len(tests) == 4
        for t in tests:
            lin = t["checker"].checker_map["register"] \
                .checker.checker_map["linear"]
            assert lin.device == torch.device("cpu")
            assert lin.algorithm == "competition"
            assert lin.model == cas_register()


def test_missing_card_raises_before_setup(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device resolves")
    for server in ("mini", "deb"):
        for reconfigure in (False, True):
            with pytest.raises(RuntimeError, match="CUDA"):
                rt.rethinkdb_test({**_options(tmp_path), "server": server,
                                   "reconfigure": reconfigure,
                                   "device": None})
    with pytest.raises(RuntimeError, match="CUDA"):
        next(rt.rethinkdb_tests({**_options(tmp_path), "device": None}))
    assert not (tmp_path / "cluster").exists()
